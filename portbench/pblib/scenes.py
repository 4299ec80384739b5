"""What the Scene drivers share: the configuration's Scene built by the
program or by the reference, a Scene's state to hold and put back, and the
comparison of two Scenes' pieces and bodies."""

from __future__ import annotations

import importlib

import torch

from pblib import compare, configs, meshes


def build(package: str, config: dict, device):
    """``package``'s ``Scene`` of the configuration's mesh at its
    ``SceneConfig``, spawn and prepare seed."""
    Scene = importlib.import_module(package + ".scene").Scene
    v, f = meshes.mesh(config["mesh"])
    return Scene((v, f), configs.scene(package, config["scene"]), spawn=config["spawn"],
                 seed=config["scene_seed"], device=device)


def state(sc):
    """What a click or a frame replaces: pieces, bodies, x0, time, events."""
    return sc.pieces, sc.phys, sc._x0, sc.time, list(sc.events)


def restore(sc, st):
    sc.pieces, sc.phys, sc._x0, sc.time, events = st
    sc.events = list(events)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def numbers(got_pieces, got_phys, want_pieces, want_phys, scale: float) -> dict:
    """``compare.piece_gaps`` and ``compare.body_gaps`` of two states."""
    return {**compare.piece_gaps(got_pieces, want_pieces, scale),
            **compare.body_gaps(got_phys, want_phys, scale)}


def worst(*results) -> dict:
    """Each number's largest reading over several comparisons."""
    out = {}
    for r in results:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out
