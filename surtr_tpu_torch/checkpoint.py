"""Checkpoint and resume (counterpart of ``surtr_tpu/checkpoint.py``).

A snapshot is one ``.npz`` file with the JAX package's array names
("pieces:convex/face_verts", "ctx:bb_center", "bodies:x", "x0:",
"meta:time", "meta:key", ...), so a snapshot written by either package
loads into the other. "meta:key" is carried through as an opaque array.
The physics piece tables are derived state: they are rebuilt from the
pieces on load and the saved body states put on top.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from surtr_tpu_torch.config import SceneConfig
from surtr_tpu_torch.fracture.types import FractureContext, PieceSet
from surtr_tpu_torch.physics.scene import build_scene
from surtr_tpu_torch.types import ConvexPoly, RigidState


def _flatten(prefix: str, obj, out: dict):
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _flatten(f"{prefix}/{f.name}" if prefix else f.name, getattr(obj, f.name), out)
    else:
        out[prefix] = obj.detach().cpu().numpy()


def save_scene(path: str, scene) -> None:
    """Snapshot a ``surtr_tpu_torch.scene.Scene`` to an ``.npz`` file."""
    arrays = {}
    for name, tree in (("pieces", scene.pieces), ("ctx", scene.ctx),
                       ("bodies", scene.phys.bodies)):
        flat = {}
        _flatten("", tree, flat)
        arrays.update({f"{name}:{k}": v for k, v in flat.items()})
    arrays["x0:"] = scene._x0.detach().cpu().numpy()
    arrays["meta:time"] = np.asarray(scene.time)
    arrays["meta:key"] = np.asarray(scene.key)
    np.savez_compressed(path, **arrays)


def load_scene(path: str, config: SceneConfig | None = None, device="cuda"):
    """Restore a Scene from an ``.npz`` snapshot onto ``device``."""
    from surtr_tpu_torch.scene import Scene

    data = np.load(path)
    dev = torch.device(device)

    def g(k, dtype=None):
        t = torch.as_tensor(np.asarray(data[k]), device=dev)
        return t if dtype is None else t.to(dtype)

    def poly(prefix):
        return ConvexPoly(g(f"{prefix}/face_verts"), g(f"{prefix}/n_verts", torch.int32),
                          g(f"{prefix}/planes"))

    pieces = PieceSet(convex=poly("pieces:convex"), mesh=g("pieces:mesh"),
                      mesh_valid=g("pieces:mesh_valid"), valid=g("pieces:valid"),
                      group=g("pieces:group", torch.int32), tag=g("pieces:tag", torch.int32))
    ctx = FractureContext(
        bb_center=g("ctx:bb_center"), bb_min=g("ctx:bb_min"), bb_max=g("ctx:bb_max"),
        max_axis_scale=g("ctx:max_axis_scale"), partial_pattern=poly("ctx:partial_pattern"),
        general_pattern=poly("ctx:general_pattern"), sphere_cloud=g("ctx:sphere_cloud"))
    bodies = RigidState(**{f.name: g(f"bodies:{f.name}") for f in dataclasses.fields(RigidState)})

    sc = Scene.__new__(Scene)
    sc.cfg = config or SceneConfig()
    sc.device = dev
    sc.pieces = pieces
    sc.ctx = ctx
    sc.key = np.asarray(data["meta:key"])
    sc.time = float(data["meta:time"])
    sc.events = []
    sc.prepare_metrics = {}
    sc.phys = dataclasses.replace(build_scene(pieces, sc.cfg.physics), bodies=bodies)
    sc._x0 = g("x0:")
    return sc
