"""k-DOP slab fitting (counterpart of ``surtr_tpu/ops/kdop.py``;
reference Kdop::KdopContainer): per direction the min/max support over the
masked vertex set, emitted as a pair of outward slab planes pushed out by
``gap``."""

from __future__ import annotations

import functools

import numpy as np
import torch

from plainref.ops.linalg import supports

BIG = 3.4e38

_DOP26 = np.asarray(
    [
        (1, 0, 0), (0, 1, 0), (0, 0, 1),
        (1, 1, 0), (1, -1, 0), (1, 0, 1), (1, 0, -1), (0, 1, 1), (0, 1, -1),
        (1, 1, 1), (1, 1, -1), (1, -1, 1), (1, -1, -1),
    ],
    np.float64,
)
_DOP26 /= np.linalg.norm(_DOP26, axis=1, keepdims=True)


@functools.lru_cache(maxsize=None)
def dop26_directions(dtype=torch.float32, device=None) -> torch.Tensor:
    """The 13 unit axes of a 26-DOP (coordinate axes, face diagonals, corner
    diagonals), normalized in float64 and rounded once to ``dtype``. One
    tensor per (dtype, device), made at first use: on the card a copy from
    host memory waits for the stream, so no call after the first makes one.
    Callers must not write to it."""
    return torch.as_tensor(_DOP26, dtype=dtype, device=device)


def kdop_planes(verts, vert_mask, dirs, dir_mask=None, gap=0.0):
    """verts (..., N, 3); vert_mask (..., N); dirs (K, 3) or (..., K, 3);
    dir_mask (..., K). Returns ((..., 2K, 4) [max planes; min planes],
    (..., 2K) mask)."""
    dirs = dirs.expand(verts.shape[:-2] + dirs.shape[-2:])
    t = supports(verts, dirs)                                  # (..., N, K)
    m = vert_mask[..., :, None]
    tmax = torch.amax(torch.where(m, t, -BIG), dim=-2)
    tmin = torch.amin(torch.where(m, t, BIG), dim=-2)
    gap = torch.as_tensor(gap, dtype=t.dtype, device=t.device)
    pmax = torch.cat([dirs, (-(tmax + gap))[..., None]], dim=-1)
    pmin = torch.cat([-dirs, (tmin - gap)[..., None]], dim=-1)
    planes = torch.cat([pmax, pmin], dim=-2)
    if dir_mask is None:
        pm = torch.ones(planes.shape[:-1], dtype=torch.bool, device=t.device)
    else:
        pm = torch.cat([dir_mask, dir_mask], dim=-1).expand(planes.shape[:-1])
    any_vert = torch.any(vert_mask, dim=-1)[..., None]
    return planes, pm & any_vert
