"""The numbers that decide ``correct``: what the program produced against
what the reference worked out from the same inputs, slot for slot.

Each function takes the two sides' objects by their field names (the
program's and the reference's classes differ), on the CPU."""

from __future__ import annotations

import dataclasses
import importlib
import math

import torch


def tree_map(tree, fn):
    """``fn`` on every tensor of nested dataclasses, dicts, tuples and
    lists; anything else is kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(v, fn) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_map(getattr(tree, f.name), fn)
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


def to_cpu(tree):
    return tree_map(tree, lambda t: t.detach().to("cpu"))


def as_reference(tree, program: str = "surtr_tpu_torch", reference: str = "plainref"):
    """The program's state in the reference's classes (the class of the same
    name in the reference's module of the same path), for a reference that
    has to start from the program's own state."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(as_reference(v, program, reference) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        mod = type(tree).__module__
        if mod.split(".")[0] == program:
            cls = getattr(importlib.import_module(reference + mod[len(program):]),
                          type(tree).__name__)
            return cls(**{f.name: as_reference(getattr(tree, f.name), program, reference)
                          for f in dataclasses.fields(tree) if f.init})
    return tree


def _gap(a: torch.Tensor, b: torch.Tensor, keep: torch.Tensor) -> float:
    """Largest |a - b| where ``keep`` (broadcast), in float64; a NaN on one
    side only counts as infinite, NaN on both as equal."""
    a, b = a.double(), b.double()
    d = (a - b).abs()
    both = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both, 0.0, torch.nan_to_num(d, nan=math.inf, posinf=math.inf))
    d = torch.where(keep, d, 0.0)
    return float(d.max()) if d.numel() else 0.0


def piece_gaps(got, want, scale: float) -> dict:
    """Two PieceSets slot for slot. ``piece_slots``: slots whose validity,
    group, tag, face counts or mesh-triangle mask differ (all of them when
    the shapes differ). ``piece_gap``: over the slots valid on both sides,
    the largest difference of a face-loop vertex live on both, a face
    plane live on both (normal; offset ÷ ``scale``) or a mesh corner valid
    on both, vertices ÷ ``scale``."""
    gc, wc = got.convex, want.convex
    if (got.valid.shape != want.valid.shape or gc.face_verts.shape != wc.face_verts.shape
            or got.mesh.shape != want.mesh.shape):
        return {"piece_slots": int(max(got.valid.numel(), want.valid.numel())),
                "piece_gap": math.inf}
    P = want.valid.shape[0]
    gnv, wnv = gc.n_verts.reshape(P, -1), wc.n_verts.reshape(P, -1)
    both = got.valid & want.valid
    same = ((got.valid == want.valid)
            & (~both | ((got.group == want.group) & (got.tag == want.tag)
                        & (gnv == wnv).all(1)
                        & (got.mesh_valid == want.mesh_valid).reshape(P, -1).all(1))))
    S = wc.face_verts.shape[-2]
    nv = torch.minimum(gc.n_verts, wc.n_verts)                     # (P, F)
    live_face = (nv > 0) & both[:, None]
    live_slot = (torch.arange(S) < nv[..., None]) & both[:, None, None]
    mesh_ok = got.mesh_valid & want.mesh_valid & both[:, None]
    gaps = [
        _gap(gc.face_verts, wc.face_verts, live_slot[..., None]) / scale,
        _gap(gc.planes[..., :3], wc.planes[..., :3], live_face[..., None]),
        _gap(gc.planes[..., 3], wc.planes[..., 3], live_face) / scale,
        _gap(got.mesh, want.mesh, mesh_ok[..., None, None]) / scale,
    ]
    return {"piece_slots": int((~same).sum()), "piece_gap": max(gaps)}


def body_gaps(got, want, scale: float) -> dict:
    """Two PhysicsScenes body for body. ``body_slots``: bodies whose
    activity differs and pieces whose owner or validity differs (all when
    the shapes differ). ``body_gap``: over the bodies active on both
    sides, the largest difference of position ÷ ``scale``, of the
    quaternion, and of the linear and angular velocities ÷ max(1, the
    reference's largest)."""
    gb, wb = got.bodies, want.bodies
    if gb.x.shape != wb.x.shape or got.piece_owner.shape != want.piece_owner.shape:
        return {"body_slots": int(max(gb.x.shape[0], wb.x.shape[0])), "body_gap": math.inf}
    bad = int((gb.active != wb.active).sum()) + int(
        ((got.piece_owner != want.piece_owner) | (got.piece_valid != want.piece_valid)).sum())
    act = (gb.active & wb.active)[:, None]
    vs = max(1.0, float(wb.v.abs().max())) if wb.v.numel() else 1.0
    ws = max(1.0, float(wb.w.abs().max())) if wb.w.numel() else 1.0
    gap = max(_gap(gb.x, wb.x, act) / scale, _gap(gb.q, wb.q, act),
              _gap(gb.v, wb.v, act) / vs, _gap(gb.w, wb.w, act) / ws)
    return {"body_slots": bad, "body_gap": gap}


def image_gap(got: torch.Tensor, want: torch.Tensor) -> dict:
    """``image_gap``: the largest difference of a pixel's channel (images
    in [0, 1]); infinite when the shapes differ."""
    if got.shape != want.shape:
        return {"image_gap": math.inf}
    return {"image_gap": _gap(got, want, torch.ones((), dtype=torch.bool))}
