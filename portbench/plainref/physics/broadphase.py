"""The broadphases that are plain PyTorch on both devices (counterparts of
``surtr_tpu/physics/step.py``): ``block_sweep``, the XLA blocked
full-recall sweep ``_broadphase``; ``morton`` and ``morton_window_sweep``,
the XLA Morton-window sweep ``_broadphase_sorted`` (also the plain version
of kernel B12, ``broadphase_cuda``, which takes K <= 2·window only);
``grid_sweep``, the uniform-grid sweep ``_broadphase_grid``; and the
``pidx[pidx]`` mutual mask.

The exact sweep's contract, as the JAX package's ``jax.lax.top_k`` over the
score row ``where(ok, -d², -BIG)`` gives it: each piece lists the K nearest pieces
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

from plainref.ops.linalg import dot3

BIG = 3.4e38


def block_sweep(centers, lo, hi, owner, valid, K: int, block: int):
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


def morton(centers: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """30-bit Morton code of the centers quantized to 1024 steps on one
    uniform scale (the largest valid extent); invalid rows get 0x7FFFFFFF
    so that they sort last. The JAX package's ``step._morton``."""
    vm = valid[:, None]
    lo = torch.amin(torch.where(vm, centers, BIG), dim=0)
    hi = torch.amax(torch.where(vm, centers, -BIG), dim=0)
    ext = torch.clamp(torch.amax(hi - lo), min=1e-6)
    q = torch.where(vm, (centers - lo) / ext * 1023.0, 0.0)
    q = torch.clamp(q.to(torch.int32), 0, 1023)

    def spread(x):  # 10 bits → every third bit
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return torch.where(valid, code, 0x7FFFFFFF).to(torch.int32)


def window_deltas(window: int) -> list[int]:
    """The candidate order of the Morton-window sweep: +1..+W, then -1..-W."""
    return list(range(1, window + 1)) + [-d for d in range(1, window + 1)]


def morton_window_sweep(centers, lo, hi, owner, valid, K: int, window: int):
    """Morton-window broadphase (the JAX package's ``step._broadphase_sorted``):
    pieces sorted by Morton code (stable); sorted lane r tests lanes r ± d,
    d = 1..W, inside [0, Np) with the exact AABB test (both valid, other
    owner) and keeps the K best by -d², ties and filler to the earliest
    delta. Returns (pidx, pok) in original piece order, not yet mutual;
    a filler slot names the piece at the clamped rank r + d. With K > 2W
    the slots past the 2W candidates are filler at delta +1, as the JAX
    package pads its top_k."""
    Np = centers.shape[0]
    dev = centers.device
    deltas = window_deltas(window)
    order = torch.sort(morton(centers, valid), stable=True).indices
    inv = torch.empty_like(order)
    inv[order] = torch.arange(Np, device=dev)
    f = centers.dtype
    pack = torch.cat([centers, lo, hi, owner[:, None].to(f), valid[:, None].to(f)], 1)[order]
    r = torch.arange(Np, device=dev)
    rank = r[:, None] + torch.tensor(deltas, device=dev)[None, :]      # (Np, 2W)
    in_rng = (rank >= 0) & (rank < Np)
    cand = pack[torch.clamp(rank, 0, Np - 1)]                         # (Np, 2W, 11)
    c_s, lo_s, hi_s = pack[:, None, 0:3], pack[:, None, 3:6], pack[:, None, 6:9]
    over = torch.all((lo_s <= cand[..., 6:9]) & (cand[..., 3:6] <= hi_s), dim=-1)
    ok = (over & in_rng & (cand[..., 10] > 0.5) & (pack[:, None, 10] > 0.5)
          & (cand[..., 9] != pack[:, None, 9]))
    diff = c_s - cand[..., 0:3]
    d2 = dot3(diff, diff)
    score = torch.where(ok, -d2, -BIG)
    s = torch.sort(score, dim=1, descending=True, stable=True)
    top, kidx = s.values[:, :K], s.indices[:, :K]
    if K > len(deltas):
        pad = K - len(deltas)
        top = torch.cat([top, top.new_full((Np, pad), -BIG)], 1)
        kidx = torch.cat([kidx, kidx.new_zeros((Np, pad))], 1)
    part_rank = torch.clamp(torch.gather(rank, 1, kidx), 0, Np - 1)
    pidx = order[part_rank].to(torch.int32)
    return pidx[inv], (top > -BIG / 2)[inv]


def grid_sweep(centers, lo, hi, owner, valid, K: int, cap: int):
    """Uniform-grid broadphase (the JAX package's ``step._broadphase_grid``):
    full recall up to ``cap`` pieces per cell. The cell edge is the largest
    valid AABB extent, so overlapping pieces' centres lie in neighbouring
    cells; pieces sort (stable) by a packed cell key (10 bits an axis, z
    lowest), each of a piece's 9 neighbour columns (three cells along z)
    is one run of the sorted table found by ``searchsorted``, the first
    3·cap of each run are tested with the exact AABB test, and the K
    nearest are kept (ties and filler to the earlier candidate). Returns
    (pidx, pok) in original piece order, not yet mutual."""
    Np = centers.shape[0]
    dev = centers.device
    f = centers.dtype
    vm = valid[:, None]
    ext = torch.amax(torch.where(vm, hi - lo, 0.0))
    h = torch.clamp(ext, min=1e-6) * (1.0 + 1e-5)
    wlo = torch.amin(torch.where(vm, centers, BIG), dim=0)
    # Clamped before the integer conversion, which then saturates as
    # XLA's does; clipping far pieces into the boundary cell only adds
    # candidates.
    cf = torch.clamp(torch.floor((centers - wlo) / h), -2.0, 1100.0)
    cc = torch.clamp(cf.to(torch.int32) + 1, 1, 1022)
    key = (cc[:, 0] << 20) | (cc[:, 1] << 10) | cc[:, 2]
    key = torch.where(valid, key, 0x7F000000).to(torch.int32)
    order = torch.sort(key, stable=True).indices
    keys_s = key[order].contiguous()
    pack = torch.cat([centers, lo, hi, owner[:, None].to(f), valid[:, None].to(f)], 1)[order]

    dc = torch.tensor([dx * (1 << 20) + dy * (1 << 10) for dx in (-1, 0, 1) for dy in (-1, 0, 1)],
                      dtype=torch.int32, device=dev)
    probes = torch.cat([keys_s[:, None] + (dc - 1), keys_s[:, None] + (dc + 2)], 1)
    se = torch.searchsorted(keys_s, probes.contiguous())                # (Np, 18)
    start, end = se[:, :9], se[:, 9:]
    ccap = 3 * cap
    ranks = (start[:, :, None] + torch.arange(ccap, device=dev)).reshape(Np, 9 * ccap)
    rk = torch.clamp(ranks, 0, Np - 1)
    in_cell = ranks < torch.repeat_interleave(end, ccap, dim=1)

    cand = pack[rk]                                                      # (Np, 27·cap, 11)
    me = pack[:, None]
    over = torch.all((me[..., 3:6] <= cand[..., 6:9]) & (cand[..., 3:6] <= me[..., 6:9]), -1)
    ok = (over & in_cell & (cand[..., 10] > 0.5) & (me[..., 10] > 0.5)
          & (cand[..., 9] != me[..., 9]) & (rk != torch.arange(Np, device=dev)[:, None]))
    diff = me[..., 0:3] - cand[..., 0:3]
    score = torch.where(ok, -dot3(diff, diff), -BIG)
    s = torch.sort(score, dim=1, descending=True, stable=True)
    top, kidx = s.values[:, :K], s.indices[:, :K]
    part_rank = torch.gather(rk, 1, kidx)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(Np, device=dev)
    pidx = order[part_rank].to(torch.int32)
    return pidx[inv], (top > -BIG / 2)[inv]
