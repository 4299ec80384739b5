"""Exact broadphase (counterpart of ``surtr_tpu/physics/step.py``
``_broadphase``, the XLA blocked full-recall sweep, and the ``pidx[pidx]``
mutual mask). Plain PyTorch on both devices.

Contract, as the JAX package's ``jax.lax.top_k`` over the score row
``where(ok, -d², -BIG)`` gives it: each piece lists the K nearest pieces
whose margin AABBs overlap its own (other owner, both valid, not itself),
nearest first with ties to the lower index; when fewer than K overlap, the
remaining slots hold the lowest-index non-overlapping pieces (pok false).
Those filler slots matter: the mutual test reads whole partner lists.

The overlap matrix is built block by block and reduced to its nonzero
pairs, which are then ranked with stable sorts, so the selection is
deterministic on either device and costs no (Np, Np) sort.
"""

from __future__ import annotations

import torch

from surtr_tpu_torch.ops.linalg import dot3


def broadphase_exact(centers, lo, hi, owner, valid, K: int, block: int):
    """centers/lo/hi (Np, 3), owner (Np,), valid (Np,) → (pidx (Np, K) i32,
    pok (Np, K) bool)."""
    Np = centers.shape[0]
    dev = centers.device
    rows, cols = [], []
    for r0 in range(0, Np, block):
        r1 = min(r0 + block, Np)
        ok = torch.all((lo[r0:r1, None] <= hi[None]) & (lo[None] <= hi[r0:r1, None]), dim=-1)
        ok &= (owner[r0:r1, None] != owner[None]) & valid[r0:r1, None] & valid[None]
        ok[torch.arange(r1 - r0, device=dev), torch.arange(r0, r1, device=dev)] = False
        r, c = torch.nonzero(ok, as_tuple=True)
        rows.append(r + r0)
        cols.append(c)
    r = torch.cat(rows)
    c = torch.cat(cols)                      # row-major: row, then column ascending
    d = centers[r] - centers[c]
    d2 = dot3(d, d)
    o = torch.sort(d2, stable=True).indices  # nearest first, ties keep column order
    o = o[torch.sort(r[o], stable=True).indices]
    r, c = r[o], c[o]
    n_ok = torch.bincount(r, minlength=Np)
    start = torch.cumsum(n_ok, 0) - n_ok
    rank = torch.arange(r.shape[0], device=dev) - start[r]
    keep = rank < K
    pidx = torch.zeros((Np, K), dtype=torch.int64, device=dev)
    pidx[r[keep], rank[keep]] = c[keep]
    n_top = torch.clamp(n_ok, max=K)
    pok = torch.arange(K, device=dev) < n_top[:, None]

    # Filler: the lowest indices outside each row's overlap set. A row with
    # n < K overlaps has its whole set in pidx, so the first 2K indices
    # hold enough fillers; beyond Np the slot takes index 0.
    L = min(2 * K, Np)
    cand = torch.arange(L, device=dev).expand(Np, L)
    listed = (cand[:, :, None] == pidx[:, None, :]) & pok[:, None, :]
    free = ~listed.any(-1)
    fill_rank = torch.cumsum(free.to(torch.int64), dim=1) - 1 + n_top[:, None]
    put = free & (fill_rank < K)
    fr, fc = torch.nonzero(put, as_tuple=True)
    pidx[fr, fill_rank[fr, fc]] = cand[fr, fc]
    return pidx.to(torch.int32), pok


def mutual(pidx: torch.Tensor, pok: torch.Tensor) -> torch.Tensor:
    """pok & (the partner's list holds this piece): the JAX package's
    ``any(pidx[pidx] == i)``, filler slots included."""
    Np = pidx.shape[0]
    me = torch.arange(Np, device=pidx.device)[:, None, None]
    return pok & torch.any(pidx.long()[pidx.long()] == me, dim=-1)
