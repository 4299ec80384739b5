"""Core containers (counterpart of ``surtr_tpu/types.py``).

``ConvexPoly`` is the padded, fixed-topology polytope: a face soup of
(..., F, S, 3) vertex loops, (..., F) valid counts and (..., F, 4) outward
planes. Conventions: plane (n, d) with signed distance n·x + d, the kept
side is negative, face loops wind CCW seen from outside.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from plainref.ops.linalg import dot3, sqrt_rn


@dataclasses.dataclass
class ConvexPoly:
    """face_verts (..., F, S, 3) f32; n_verts (..., F) i32 (0 = invalid
    face); planes (..., F, 4) f32. All ``n_verts == 0`` is the empty
    polytope."""

    face_verts: torch.Tensor
    n_verts: torch.Tensor
    planes: torch.Tensor

    @property
    def F(self) -> int:
        return self.face_verts.shape[-3]

    @property
    def S(self) -> int:
        return self.face_verts.shape[-2]

    @property
    def batch_shape(self):
        return tuple(self.face_verts.shape[:-3])

    @property
    def device(self):
        return self.face_verts.device

    def face_mask(self) -> torch.Tensor:
        """(..., F) bool — faces with >= 3 vertices."""
        return self.n_verts >= 3

    def slot_mask(self) -> torch.Tensor:
        """(..., F, S) bool — valid vertex slots."""
        slots = torch.arange(self.S, dtype=torch.int32, device=self.device)
        return slots < self.n_verts[..., None]

    def is_empty(self) -> torch.Tensor:
        """(...,) bool — no valid face."""
        return ~torch.any(self.face_mask(), dim=-1)

    def map(self, fn) -> "ConvexPoly":
        """Apply ``fn`` to every field (the pytree map of the JAX package)."""
        return ConvexPoly(fn(self.face_verts), fn(self.n_verts), fn(self.planes))


@dataclasses.dataclass
class TriSoup:
    """Padded indexed triangle mesh (visual geometry): verts (..., V, 3)
    f32, tris (..., T, 3) i32, tri_valid (..., T) bool. Vertices are welded
    (shared indices), so components over shared vertices are the
    reference's mesh islands."""

    verts: torch.Tensor
    tris: torch.Tensor
    tri_valid: torch.Tensor

    @property
    def V(self) -> int:
        return self.verts.shape[-2]

    @property
    def T(self) -> int:
        return self.tris.shape[-2]

    def corners(self) -> torch.Tensor:
        """(..., T, 3, 3) gathered corner positions (negative indices read
        vertex 0)."""
        idx = torch.clamp(self.tris.long(), min=0)
        src = self.verts[..., None, :, :].expand(idx.shape[:-1] + self.verts.shape[-2:])
        return torch.gather(src, -2, idx[..., None].expand(idx.shape + (3,)))


@dataclasses.dataclass
class RigidState:
    """Batched rigid-body state.

    x (..., N, 3) position; q (..., N, 4) unit quaternion (w, x, y, z);
    v (..., N, 3) linear velocity; w (..., N, 3) angular velocity (world);
    inv_mass (..., N); inv_inertia_body (..., N, 3, 3) (body frame);
    active (..., N) bool."""

    x: torch.Tensor
    q: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    inv_mass: torch.Tensor
    inv_inertia_body: torch.Tensor
    active: torch.Tensor

    @property
    def N(self) -> int:
        return self.x.shape[-2]


def empty_poly(F: int, S: int, batch_shape=(), dtype=torch.float32,
               device=None) -> ConvexPoly:
    batch_shape = tuple(batch_shape)
    return ConvexPoly(
        face_verts=torch.zeros(batch_shape + (F, S, 3), dtype=dtype, device=device),
        n_verts=torch.zeros(batch_shape + (F,), dtype=torch.int32, device=device),
        planes=torch.zeros(batch_shape + (F, 4), dtype=dtype, device=device),
    )


def unit_cube(F: int = 32, S: int = 16, dtype=torch.float32, device=None) -> ConvexPoly:
    """Axis-aligned unit cube centered at the origin ([-0.5, 0.5]^3); faces
    +x, -x, +y, -y, +z, -z in slots 0-5, loops CCW from outside."""
    h = 0.5
    quads = np.array(
        [
            [[h, -h, -h], [h, h, -h], [h, h, h], [h, -h, h]],
            [[-h, -h, -h], [-h, -h, h], [-h, h, h], [-h, h, -h]],
            [[-h, h, -h], [-h, h, h], [h, h, h], [h, h, -h]],
            [[-h, -h, -h], [h, -h, -h], [h, -h, h], [-h, -h, h]],
            [[-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h]],
            [[-h, -h, -h], [-h, h, -h], [h, h, -h], [h, -h, -h]],
        ],
        dtype=np.float64,
    )
    normals = np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        dtype=np.float64,
    )
    fv = np.zeros((F, S, 3))
    pl = np.zeros((F, 4))
    nv = np.zeros((F,), np.int32)
    fv[:6, :4] = quads
    pl[:6, :3] = normals
    pl[:6, 3] = -h
    nv[:6] = 4
    return ConvexPoly(
        face_verts=torch.as_tensor(fv, dtype=dtype, device=device),
        n_verts=torch.as_tensor(nv, device=device),
        planes=torch.as_tensor(pl, dtype=dtype, device=device),
    )


def scale_poly(p: ConvexPoly, s) -> ConvexPoly:
    """Anisotropic scale about the origin (reference: Poly::Scale)."""
    s = torch.as_tensor(s, dtype=p.face_verts.dtype, device=p.device).expand(3)
    fv = p.face_verts * s
    n = p.planes[..., :3] / s
    norm = sqrt_rn(dot3(n, n))[..., None]
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    d = p.planes[..., 3:4] / safe
    # (n / s) / safe as XLA rewrites it under jit, n / (s · safe): the JAX
    # package's bits.
    n = p.planes[..., :3] / (s * safe)
    return ConvexPoly(fv, p.n_verts, torch.cat([n, d], dim=-1))


def translate_poly(p: ConvexPoly, t) -> ConvexPoly:
    """Translate (reference: Poly::Translate)."""
    t = torch.as_tensor(t, dtype=p.face_verts.dtype, device=p.device)
    fv = p.face_verts + t
    n = p.planes[..., :3]
    d = p.planes[..., 3:4] - dot3(n, t)[..., None]
    return ConvexPoly(fv, p.n_verts, torch.cat([n, d], dim=-1))


def transform_poly(p: ConvexPoly, R: torch.Tensor, t) -> ConvexPoly:
    """Rigid transform x -> R x + t (reference: Poly::Transform); R (3, 3),
    each row's product in ``dot3`` order."""
    t = torch.as_tensor(t, dtype=p.face_verts.dtype, device=p.device)
    R = torch.as_tensor(R, dtype=p.face_verts.dtype, device=p.device)
    fv = dot3(R, p.face_verts[..., None, :]) + t
    n = dot3(R, p.planes[..., None, :3])
    d = p.planes[..., 3:4] - dot3(n, t)[..., None]
    return ConvexPoly(fv, p.n_verts, torch.cat([n, d], dim=-1))


def map_tree(tree, fn):
    """``fn`` applied to every tensor of nested dataclasses, dicts, tuples,
    lists or tensors (the pytree map of the JAX package)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(v, fn) for v in tree)
    return dataclasses.replace(tree, **{f.name: map_tree(getattr(tree, f.name), fn)
                                        for f in dataclasses.fields(tree)})


def stack_tree(trees: list):
    """Stack a list of like-shaped containers (nested dataclasses, dicts or
    tensors) field by field along a new leading axis (the counterpart of
    ``jax.tree_util.tree_map(jnp.stack, *trees)``)."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, dict):
        return {k: stack_tree([t[k] for t in trees]) for k in first}
    return dataclasses.replace(first, **{f.name: stack_tree([getattr(t, f.name) for t in trees])
                                         for f in dataclasses.fields(first)})


def index_tree(tree, i: int):
    """Element (or slice) ``i`` of the leading axis of every field of a
    stacked container (the inverse of ``stack_tree``)."""
    return map_tree(tree, lambda a: a[i])


def shard_bounds(M: int, devices) -> list[slice]:
    """Even split of a leading axis of M over the devices; raises when it
    does not divide (as ``shard_map`` does)."""
    n = len(devices)
    if n < 1 or M % n:
        raise ValueError(f"a batch of {M} does not split evenly over {n} devices")
    m = M // n
    return [slice(i * m, (i + 1) * m) for i in range(n)]


def device_context(device):
    """The CUDA device guard of ``device`` (the hand-written kernels launch
    on the current device), or a no-op for the CPU."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
