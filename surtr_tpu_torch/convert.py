"""State carried across between the JAX package and the port.

Turns the JAX package's containers, seen as numpy arrays (any object with
the same field names whose leaves convert with ``numpy.asarray``), into the
port's containers and back. ``FractureConfig`` converts through
``dataclasses.asdict``. The tests use it to feed the same intermediate state
to both sides; nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from surtr_tpu_torch.config import FractureConfig
from surtr_tpu_torch.fracture.types import FractureContext, PieceSet
from surtr_tpu_torch.types import ConvexPoly


def to_torch(a, device=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def poly_from(p, device=None) -> ConvexPoly:
    return ConvexPoly(
        to_torch(p.face_verts, device),
        to_torch(p.n_verts, device).to(torch.int32),
        to_torch(p.planes, device),
    )


def poly_to_numpy(p: ConvexPoly) -> dict:
    return {"face_verts": to_numpy(p.face_verts), "n_verts": to_numpy(p.n_verts),
            "planes": to_numpy(p.planes)}


def pieces_from(ps, device=None) -> PieceSet:
    return PieceSet(
        convex=poly_from(ps.convex, device),
        mesh=to_torch(ps.mesh, device),
        mesh_valid=to_torch(ps.mesh_valid, device),
        valid=to_torch(ps.valid, device),
        group=to_torch(ps.group, device).to(torch.int32),
        tag=to_torch(ps.tag, device).to(torch.int32),
    )


def pieces_to_numpy(ps: PieceSet) -> dict:
    return {
        "convex": poly_to_numpy(ps.convex),
        "mesh": to_numpy(ps.mesh),
        "mesh_valid": to_numpy(ps.mesh_valid),
        "valid": to_numpy(ps.valid),
        "group": to_numpy(ps.group),
        "tag": to_numpy(ps.tag),
    }


def context_from(ctx, device=None) -> FractureContext:
    return FractureContext(
        bb_center=to_torch(ctx.bb_center, device),
        bb_min=to_torch(ctx.bb_min, device),
        bb_max=to_torch(ctx.bb_max, device),
        max_axis_scale=to_torch(ctx.max_axis_scale, device),
        partial_pattern=poly_from(ctx.partial_pattern, device),
        general_pattern=poly_from(ctx.general_pattern, device),
        sphere_cloud=to_torch(ctx.sphere_cloud, device),
    )


def context_to_numpy(ctx: FractureContext) -> dict:
    out = {}
    for f in dataclasses.fields(ctx):
        v = getattr(ctx, f.name)
        out[f.name] = poly_to_numpy(v) if isinstance(v, ConvexPoly) else to_numpy(v)
    return out


def config_from(cfg) -> FractureConfig:
    """The port's FractureConfig from any dataclass with the same fields."""
    return FractureConfig(**dataclasses.asdict(cfg))


def config_to_dict(cfg: FractureConfig) -> dict:
    return dataclasses.asdict(cfg)
