"""State carried across between the JAX package and the port.

Turns the JAX package's containers, seen as numpy arrays (any object with
the same field names whose leaves convert with ``numpy.asarray``), into the
port's containers and back: pieces, fracture contexts and physics scenes.
The configurations convert through ``dataclasses.asdict``. Every
conversion works field by field, so a stacked batch (a leading (M,) axis on
every field, as the JAX package's ``batch_decompose`` and ``batch_step``
take and give it) converts as it stands. The tests use it to feed the same
intermediate state to both sides; nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from surtr_tpu_torch.config import FractureConfig, PhysicsConfig, RenderConfig, SceneConfig
from surtr_tpu_torch.fracture.types import FractureContext, PieceSet
from surtr_tpu_torch.physics.scene import PhysicsScene
from surtr_tpu_torch.types import ConvexPoly, RigidState


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


def physics_config_from(cfg) -> PhysicsConfig:
    """The port's PhysicsConfig from any dataclass with the same fields."""
    return PhysicsConfig(**dataclasses.asdict(cfg))


def render_config_from(cfg) -> RenderConfig:
    """The port's RenderConfig from any dataclass with the same fields."""
    return RenderConfig(**dataclasses.asdict(cfg))


def scene_config_from(cfg) -> SceneConfig:
    """The port's SceneConfig from the JAX package's (or any with the same
    three parts)."""
    return SceneConfig(fracture=config_from(cfg.fracture),
                       physics=physics_config_from(cfg.physics),
                       render=render_config_from(cfg.render))


def _field(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def rigid_from(rs, device=None) -> RigidState:
    return RigidState(**{f.name: to_torch(_field(rs, f.name), device)
                         for f in dataclasses.fields(RigidState)})


def scene_from(sc, device=None) -> PhysicsScene:
    """A physics scene carried into the port: the JAX package's
    ``PhysicsScene``, or the dict of numpy arrays ``scene_to_numpy`` gives."""
    fields = {}
    for f in dataclasses.fields(PhysicsScene):
        v = _field(sc, f.name)
        fields[f.name] = rigid_from(v, device) if f.name == "bodies" else to_torch(v, device)
    return PhysicsScene(**fields)


def scene_to_numpy(sc: PhysicsScene) -> dict:
    """The port's scene as numpy arrays, field by field (``bodies`` a dict)."""
    out = {}
    for f in dataclasses.fields(sc):
        v = getattr(sc, f.name)
        out[f.name] = ({g.name: to_numpy(getattr(v, g.name)) for g in dataclasses.fields(v)}
                       if f.name == "bodies" else to_numpy(v))
    return out
