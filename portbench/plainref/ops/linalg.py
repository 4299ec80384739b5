"""Small contraction and compaction helpers (counterpart of
``surtr_tpu/ops/linalg.py``).

Compaction packs flagged entries front-aligned with a scatter into a
trash-slot buffer: the values are copied, so they stay bitwise equal to the
JAX package's one-hot contraction.
"""

from __future__ import annotations

import torch


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a0·b0 + a1·b1) + a2·b2 over the last axis, in that order.

    Written out rather than ``torch.sum(a * b, -1)``: the reduction order of
    a library sum is unspecified, while the CUDA kernels round exactly this
    sequence (built without FMA contraction), so first-of-ties picks and
    tolerance tests see the same bits on both sides."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def dotn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b, -1) over an axis of any length, added in index order (a
    length-3 axis gives ``dot3``'s bits)."""
    s = a[..., 0] * b[..., 0]
    for j in range(1, a.shape[-1]):
        s = s + a[..., j] * b[..., j]
    return s


def supports(verts: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) · (..., K, 3) → (..., N, K) as a broadcast multiply-add
    (full f32, no matmul precision question)."""
    return dot3(verts[..., :, None, :], dirs[..., None, :, :])


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Square root rounded to nearest in ``x``'s float32, on every device.

    PyTorch's vectorized float32 ``sqrt`` on the CPU is not correctly
    rounded (one ulp off for about 0.7% of inputs), while the kernels' and
    the GPU's are; the float64 root rounded once to float32 is exact (53 ≥
    2·24 + 2 bits), so the plain versions agree on the CPU and the card."""
    return torch.sqrt(x.double()).to(x.dtype)


def div_rn(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded as one true division on every device. The card
    divides a float tensor by a Python number as a product with its rounded
    reciprocal, which can differ by one ulp; a divisor tensor on the
    device takes the true division, as the CPU always does."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def matvec3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) → (..., 3), each row in ``dot3`` order."""
    return dot3(m, v[..., None, :])


def rot_points(R: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Rotate point sets: R (..., 3, 3), pts (..., N, 3) → (..., N, 3)."""
    return dot3(R[..., None, :, :], pts[..., :, None, :])


def compact(vals: torch.Tensor, flags: torch.Tensor, S_out: int):
    """Stream compaction along axis -2.

    vals (..., E, D); flags (..., E) bool. Returns ((..., S_out, D) packed
    front-aligned with zeros after, (...,) counts min(#flags, S_out))."""
    pos = torch.cumsum(flags.to(torch.int32), dim=-1)          # 1-based
    take = flags & (pos <= S_out)
    idx = torch.where(take, pos - 1, torch.full_like(pos, S_out)).long()
    D = vals.shape[-1]
    out = torch.zeros(
        vals.shape[:-2] + (S_out + 1, D), dtype=vals.dtype, device=vals.device
    )
    out.scatter_(-2, idx[..., None].expand(idx.shape + (D,)), vals)
    n = torch.clamp(pos[..., -1], max=S_out) if pos.shape[-1] else pos.sum(-1)
    return out[..., :S_out, :], n.to(torch.int32)


def pack_rows(vals: torch.Tensor, counts: torch.Tensor, S_out: int):
    """Pack the first ``counts[r]`` entries of each row, front-aligned.

    vals (T, S, D); counts (T,). Returns ((S_out, D), total) with total
    clamped to S_out."""
    T, S, D = vals.shape
    counts = torch.clamp(counts, max=S)
    ok = torch.arange(S, device=vals.device)[None, :] < counts[:, None]
    out, n = compact(vals.reshape(T * S, D), ok.reshape(T * S), S_out)
    return out, n


def compact_big(vals: torch.Tensor, flags: torch.Tensor, S_out: int, chunk: int = 128):
    """Compaction of a large unbatched pool: vals (E, D), flags (E,) →
    ((S_out, D) the first S_out flagged rows front-aligned, zeros after;
    count min(#flags, S_out)). The JAX package packs chunks of ``chunk``
    rows in a scan to stay off a large one-hot on the TPU; the scatter of
    ``compact`` has no such cost, so it serves here and ``chunk`` is
    accepted for the same signature."""
    return compact(vals, flags, S_out)
