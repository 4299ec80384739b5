"""The two broadphase kernels with device dispatch.

* ``broadphase_exact`` (kernel B6, ``csrc/broadphase_exact.cu``; replaces
  ``surtr_tpu/physics/broadphase_pallas.py`` ``_bp_exact_kernel`` via
  ``broadphase_exact_pallas``): full-recall sweep-and-prune. For each
  valid piece i, the K smallest unique keys ``(q(d²) << ID_BITS) | j``
  over every valid j of another owner whose margin AABB overlaps i's
  (d² of centers normalized to the valid extent, q its truncation to
  31 - ID_BITS bits), and θᵢ, the K-th key (IMAX when fewer than K).
  Returns ``pidx = key & ID_MASK`` (empty slots: ID_MASK, beyond Np),
  ``pok = key != IMAX`` (not yet mutual) and ``(key_ji, θ)`` for
  ``apply_theta_mutual``.
* ``broadphase_sorted`` (kernel B12, ``csrc/broadphase_sorted.cu``;
  replaces ``_bp_kernel`` via ``broadphase_sorted_pallas``): the
  Morton-window sweep of ``broadphase.morton_window_sweep`` with the mutual
  mask applied.

The plain versions (``*_reference``) run for CPU tensors; for CUDA tensors
the wrappers launch the kernel or raise. B6's glue is two hand-written
launches around one ``torch.sort`` (the sweep key; the sorted table, tile
unions and chunk intervals), mirrored in plain PyTorch by ``exact_glue``
and ``tile_schedule``. B12's is too (the Morton codes; the sorted table),
mirrored by ``sorted_glue``; its sweep's selection and mutual steps by
``window_selection`` and ``window_mutual``. Neither makes a host sync.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from plainref import _build
from plainref.ops.linalg import dot3
from plainref.physics.broadphase import (morton, morton_window_sweep, mutual,
                                                window_deltas)

BIG = 3.4e38
IMAX = 0x7FFFFFFF
# Largest pool the exact sweep takes, as in the JAX package: beyond it the
# keys' id field (ID_BITS) would leave the quantized d² fewer than 14 bits,
# and "auto" degrades to the Morton window with a RecallDegradedWarning.
MAX_EXACT_NP = 65536
MAX_K = 16          # the fast variants keep their K best in registers
LONG_K = 64         # B6: K its long variant keeps in registers (lists of 32 or 64 keys)
MAX_W = 128         # B12: windows its warp variant holds (8 candidates a lane)
MAX_SMEM = 232448   # B12: shared memory a block may opt in to (H100)
CHUNK = 128         # B6: rows per sweep chunk (the JAX kernel's block; CHUNK in the kernel)
TILE = 32           # B6: pieces per query tile and rows per row tile (a warp)
ROW = 12            # B6: floats per row of the sorted table
SROW = 12           # B12: floats per row of its sorted table
KEY_PARTS = 256     # B12: CTAs of its key launch at most (MAX_KEY_BLOCKS in the kernel)

exact_launches = 0   # kernel launches since the last reset (main-path proof), every variant
sorted_launches = 0
exact_long_launches = 0       # of which B6's long variant's
exact_general_launches = 0    # of which B6's general variant's
sorted_list_launches = 0      # of which B12's list variant's, either placement


EXACT_VARIANTS = ("tiled", "long", "general")   # the C entry's variant codes 0, 1, 2


def _exact_variant(K: int) -> str:
    """B6: "tiled" (a CTA of 4 warps a 32-piece tile, the K best in
    registers: today's sweep) for K <= 16; "long" (the same sweep, its
    lists 32 or 64 keys long, still in registers indexed by unrolled
    constants) for K <= 64; else "general" (a thread a piece over the
    chunks that can meet it, the K best in a device scratch): past 64 a
    register list would spill and the warps' merge buffer would pass a
    CTA's 48 KB of static shared memory. Np > MAX_EXACT_NP stays refused,
    as in the JAX package."""
    return "tiled" if K <= MAX_K else ("long" if K <= LONG_K else "general")


SORTED_VARIANTS = ("warp", "list", "list_scratch")   # the C entry's variant codes 0, 1, 2


def list_bytes(K: int, window: int) -> int:
    """B12's list variant with its lists in memory (W > 128): bytes of a
    warp's region, its lanes' lists of min(K, ceil(2W / 32)) 8-byte entries
    and then ceil(2W / 32) 4-byte selection words, rounded up to 8 bytes."""
    nw = -(-2 * window // 32)
    return 8 * (32 * min(K, nw) + (nw + 1) // 2)


def _sorted_variant(K: int, window: int) -> str:
    """B12: "warp" (a warp a sorted lane, K rounds of warp maxima over its
    2W candidates in registers: today's sweep) for K <= 16 and W <= 128;
    past either, "list" (a warp a lane too, each lane's candidates scored
    once and kept in order: in registers up to W = 128, past it a list a
    lane in shared memory) or, where a warp's lists pass a block's shared
    memory, "list_scratch" (the lists in a device scratch). K > 2·window
    stays refused: the JAX dispatch sends it to the XLA route."""
    if K <= MAX_K and window <= MAX_W:
        return "warp"
    return "list" if list_bytes(K, window) <= MAX_SMEM else "list_scratch"


def id_bits(Np: int) -> int:
    """Bits of the piece-id field of B6's keys: ids 0..Np-1 stay unique."""
    return max(14, (max(Np, 2) - 1).bit_length())


@functools.lru_cache(maxsize=None)
def _quant(Np: int):
    """(ID_BITS, QMAX, QS): d² ≤ 3 on normalized centers maps to
    [0, QMAX]; QS is QMAX / 3 rounded once to float32."""
    bits = id_bits(Np)
    qmax = float((1 << (31 - bits)) - 1)
    qs = float(torch.tensor(qmax / 3.0, dtype=torch.float32))
    return bits, qmax, qs


def _normalized(centers, valid):
    """Centers mapped by (c - wlo) / ext, the valid extent's low corner and
    largest side; and the per-axis valid extents."""
    vm = valid[:, None]
    wlo = torch.amin(torch.where(vm, centers, BIG), dim=0)
    whi = torch.amax(torch.where(vm, centers, -BIG), dim=0)
    ext = torch.clamp(torch.amax(whi - wlo), min=1e-6)
    return (centers - wlo) / ext, whi - wlo


def _outputs(best, bits: int):
    """(pidx, pok, (key_ji, θ)) from the ascending K best keys per piece."""
    Np = best.shape[0]
    mask = (1 << bits) - 1
    me = torch.arange(Np, dtype=torch.int32, device=best.device)[:, None]
    key_ji = (best & ~mask) | me
    return best & mask, best != IMAX, (key_ji, best[:, -1].contiguous())


def broadphase_exact_reference(centers, lo, hi, owner, valid, K: int, block: int = 512):
    """Plain version of B6: the same keys computed directly, a block of rows
    against every piece, then the K smallest (keys are unique, so no tie
    order arises). Returns what ``broadphase_exact`` returns."""
    Np = centers.shape[0]
    dev = centers.device
    bits, qmax, qs = _quant(Np)
    cn, _ = _normalized(centers, valid)
    ids = torch.arange(Np, dtype=torch.int32, device=dev)
    best = []
    for r0 in range(0, Np, block):
        r1 = min(r0 + block, Np)
        over = torch.all((lo[None] <= hi[r0:r1, None]) & (lo[r0:r1, None] <= hi[None]), dim=-1)
        ok = (over & valid[r0:r1, None] & valid[None] & (owner[r0:r1, None] != owner[None])
              & (ids[r0:r1, None] != ids[None]))
        da = cn[None, :, :] - cn[r0:r1, None, :]      # candidate minus own, as the kernel
        d2 = (da[..., 0] * da[..., 0] + da[..., 1] * da[..., 1]) + da[..., 2] * da[..., 2]
        q = torch.clamp(d2 * qs, max=qmax).to(torch.int32)
        keys = torch.where(ok, (q << bits) | ids[None], IMAX)
        kk = min(K, Np)
        top = torch.topk(keys, kk, dim=1, largest=False, sorted=True).values
        if kk < K:
            top = torch.cat([top, torch.full((r1 - r0, K - kk), IMAX, dtype=torch.int32,
                                             device=dev)], 1)
        best.append(top)
    best = torch.cat(best) if best else torch.full((0, K), IMAX, dtype=torch.int32, device=dev)
    return _outputs(best, bits)


def exact_glue(centers, lo, hi, owner, valid):
    """Plain mirror of B6's glue and of its kernel's range step: the sweep
    axis (largest valid extent, first of ties; x when nothing is valid), the
    stable sort along it with invalid rows last, the (Np_pad, ROW) sorted
    table [normalized center 3 | owner | lo 3 | valid | hi 3 | id], padded
    with zero rows to whole CHUNKs; each TILE-row tile's AABB union over
    valid rows (NT, 6) [lo 3 | hi 3] (empty: BIG, -BIG); and each CHUNK-piece
    block's contiguous chunk range [lo, hi) (NCH, 2): the chunks from the
    first whose sweep-axis interval reaches the block's low end to the last
    that starts below its high end (the JAX wrapper's prefix-max /
    suffix-min envelopes, searched; every chunk holding an overlap of the
    block lies inside it)."""
    Np = centers.shape[0]
    dev = centers.device
    f = centers.dtype
    cn, extent = _normalized(centers, valid)
    axis = torch.where(torch.any(valid), torch.argmax(extent), 0).reshape(1)
    cx = centers.index_select(1, axis)[:, 0]
    order = torch.sort(torch.where(valid, cx, BIG), stable=True).indices
    NCH = max(-(-Np // CHUNK), 1)
    Np_pad = NCH * CHUNK
    table = torch.zeros((Np_pad, ROW), dtype=f, device=dev)
    table[:Np] = torch.cat([cn, owner[:, None].to(f), lo, valid[:, None].to(f), hi,
                            torch.arange(Np, dtype=f, device=dev)[:, None]], 1)[order]
    vm = (table[:, 7] > 0.5)[:, None]
    tiles = torch.cat([torch.where(vm, table[:, 4:7], BIG).reshape(-1, TILE, 3).amin(1),
                       torch.where(vm, table[:, 8:11], -BIG).reshape(-1, TILE, 3).amax(1)], 1)
    per_chunk = CHUNK // TILE
    c_lox = tiles.index_select(1, axis)[:, 0].reshape(NCH, per_chunk).amin(1)
    c_hix = tiles.index_select(1, axis + 3)[:, 0].reshape(NCH, per_chunk).amax(1)
    reach = c_hix[None, :] >= c_lox[:, None]           # [block, chunk]
    start = c_lox[None, :] <= c_hix[:, None]
    ch = torch.arange(NCH, device=dev)
    lo_ch = torch.where(reach, ch, NCH).amin(1)
    hi_ch = torch.where(start, ch + 1, 0).amax(1)
    rng = torch.stack([lo_ch, hi_ch], 1).to(torch.int32)
    return table, tiles, rng


def tile_schedule(table, tiles, rng):
    """The walk B6's kernel makes, in plain PyTorch: ``(pairs, rows)``.
    ``pairs`` (P, 2) are the (query tile, row tile) pairs it visits: the row
    tile lies in the chunk range of the query tile's chunk and the two
    tiles' AABB unions meet. ``rows`` (P, TILE) marks, per pair, the valid
    rows of the row tile whose own AABB meets the query tile's union: the
    rows the kernel tests against each piece of the query tile."""
    NT = tiles.shape[0]
    dev = tiles.device
    u = torch.arange(NT, device=dev)
    r = rng.long()[u // (CHUNK // TILE)] * (CHUNK // TILE)
    in_range = (u[None, :] >= r[:, :1]) & (u[None, :] < r[:, 1:])
    meets = torch.all((tiles[None, :, :3] <= tiles[:, None, 3:])
                      & (tiles[:, None, :3] <= tiles[None, :, 3:]), -1)   # [query, row]
    pairs = torch.nonzero(in_range & meets)
    rows = table.reshape(NT, TILE, ROW)[pairs[:, 1]]
    q = tiles[pairs[:, 0]][:, None]
    rows_ok = ((rows[..., 7] > 0.5)
               & torch.all((rows[..., 4:7] <= q[..., 3:]) & (q[..., :3] <= rows[..., 8:11]), -1))
    return pairs, rows_ok


def _check_inputs(name, centers, lo, hi, owner, valid, K):
    Np = centers.shape[0]
    for t in (centers, lo, hi):
        if t.dtype != torch.float32 or t.shape != (Np, 3):
            raise ValueError(f"{name}: centers, lo, hi must be (Np, 3) float32")
    if owner.shape != (Np,) or valid.shape != (Np,) or valid.dtype != torch.bool:
        raise ValueError(f"{name}: owner (Np,) and valid (Np,) bool")
    if any(t.device != centers.device for t in (lo, hi, owner, valid)):
        raise TypeError(f"{name} takes tensors on one device")
    if K < 1:
        raise ValueError(f"{name}: K >= 1, got K={K}")


@functools.lru_cache(maxsize=None)
def _exact_fns():
    """B6's three C entry points: sweep key, table pack, sweep."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return (_build.bind("surtr_broadphase_exact_key", [P, I, P, I, P, P, P, P]),
            _build.bind("surtr_broadphase_exact_pack", [P, I, P, I, P, I] + [P] * 5 + [I, I]
                        + [P] * 4),
            _build.bind("surtr_broadphase_exact", [P] * 3 + [I] * 4 + [F] * 2 + [P] * 6 + [I, P]))


def _exact_kernel(centers, lo, hi, owner, valid, K):
    global exact_launches, exact_long_launches, exact_general_launches
    Np = centers.shape[0]
    dev = centers.device
    _check_inputs("broadphase_exact kernel", centers, lo, hi, owner, valid, K)
    bits, qmax, qs = _quant(Np)
    pidx = torch.empty((Np, K), dtype=torch.int32, device=dev)
    pok = torch.empty((Np, K), dtype=torch.bool, device=dev)
    key_ji = torch.empty((Np, K), dtype=torch.int32, device=dev)
    theta = torch.empty((Np,), dtype=torch.int32, device=dev)
    if Np == 0:
        return pidx, pok, (key_ji, theta)
    # Row-strided (Np, 3) views are read in place (the step hands in columns
    # of its (Np, 9) AABB table).
    c, lo, hi = (t if t.stride(1) == 1 else t.contiguous() for t in (centers, lo, hi))
    own = owner.to(torch.int32).contiguous()
    val = valid.contiguous()
    NCH = max(-(-Np // CHUNK), 1)
    NT = NCH * CHUNK // TILE
    # One float32 scratch: sort key (Np), params (4: low corner, extent),
    # axis (1, an int), table (NCH·CHUNK, ROW), tile unions (NT, 8), chunk
    # intervals (NCH, 2); every part starts 16-byte aligned.
    offs = [0]
    for n in (Np, 4, 1, NCH * CHUNK * ROW, NT * 8, NCH * 2):
        offs.append(offs[-1] + -(-n // 4) * 4)
    scratch = torch.empty((offs[-1],), dtype=torch.float32, device=dev)
    o_key, o_par, o_ax, o_tab, o_til, o_chk = (scratch.data_ptr() + 4 * o for o in offs[:-1])
    stream = _build.stream_ptr(dev)
    key_fn, pack_fn, sweep_fn = _exact_fns()
    _build.check(key_fn(c.data_ptr(), c.stride(0), val.data_ptr(), Np, o_key, o_par, o_ax,
                        stream), "surtr_broadphase_exact_key")
    order = torch.sort(scratch[:Np], stable=True).indices
    _build.check(pack_fn(c.data_ptr(), c.stride(0), lo.data_ptr(), lo.stride(0), hi.data_ptr(),
                         hi.stride(0), own.data_ptr(), val.data_ptr(), order.data_ptr(),
                         o_par, o_ax, Np, NCH, o_tab, o_til, o_chk, stream),
                 "surtr_broadphase_exact_pack")
    variant = _exact_variant(K)
    general = variant == "general"
    best = torch.empty((K, NCH * CHUNK), dtype=torch.int32, device=dev) if general else None
    rc = sweep_fn(o_tab, o_til, o_chk, Np, NCH, K, bits, qs, qmax,
                  pidx.data_ptr(), pok.data_ptr(), key_ji.data_ptr(), theta.data_ptr(), o_ax,
                  None if best is None else best.data_ptr(), EXACT_VARIANTS.index(variant),
                  stream)
    _build.check(rc, "surtr_broadphase_exact")
    exact_launches += 1
    exact_long_launches += variant == "long"
    exact_general_launches += general
    return pidx, pok, (key_ji, theta)


def broadphase_exact(centers, lo, hi, owner, valid, K: int):
    """Full-recall broadphase: (pidx (Np, K) i32, pok (Np, K) bool, (key_ji
    (Np, K) i32, θ (Np,) i32)); the kernel for CUDA tensors, the plain
    version for CPU tensors. Np ≤ MAX_EXACT_NP."""
    Np = centers.shape[0]
    if Np > MAX_EXACT_NP:
        raise ValueError(f"broadphase_exact takes Np <= {MAX_EXACT_NP}, got {Np}")
    if centers.is_cuda:
        return _exact_kernel(centers, lo, hi, owner, valid, K)
    if centers.device.type != "cpu":
        raise ValueError(f"broadphase_exact: unsupported device {centers.device}")
    return broadphase_exact_reference(centers, lo, hi, owner, valid, K)


def apply_theta_mutual(pidx, pok, mut):
    """Mutual mask of B6's result: j selected i ⇔ key(d², i) ≤ θ_j."""
    key_ji, theta = mut
    Np = theta.shape[0]
    return pok & (key_ji <= theta[torch.clamp(pidx.long(), 0, Np - 1)])


def broadphase_sorted_reference(centers, lo, hi, owner, valid, K: int, window: int):
    """Plain version of B12: the Morton-window sweep, then the mutual mask
    ``any(pidx[pidx] == i)``. (pidx, pok) in original order. B12 takes
    K <= 2·window only."""
    if K > 2 * window:
        raise ValueError(f"broadphase_sorted: K={K} > 2·window={2 * window}")
    pidx, pok = morton_window_sweep(centers, lo, hi, owner, valid, K, window)
    return pidx, mutual(pidx, pok)


def sorted_glue(centers, lo, hi, owner, valid):
    """Plain mirror of B12's glue: the Morton codes (``morton``), the order
    of their stable sort, and the sorted (Np, SROW) table [center 3 | owner
    | lo 3 | valid | hi 3 | piece id], the id as int32 bits."""
    Np = centers.shape[0]
    f = centers.dtype
    codes = morton(centers, valid)
    order = torch.sort(codes, stable=True).indices
    ids = torch.arange(Np, dtype=torch.int32, device=centers.device).view(f)
    table = torch.cat([centers, owner[:, None].to(f), lo, valid[:, None].to(f), hi, ids[:, None]],
                      1)[order]
    return codes, order, table


def window_selection(table, K: int, window: int):
    """Plain mirror of B12's selection on the sorted table: per sorted lane
    the candidate indices of its K picks, in pick order ((Np, K) int64, in
    ``window_deltas`` order), whether each pick's score is real (Np, K),
    and the lane's selection mask (Np, 2W) bool."""
    Np = table.shape[0]
    dev = table.device
    deltas = torch.tensor(window_deltas(window), device=dev)
    rank = torch.arange(Np, device=dev)[:, None] + deltas[None, :]
    cand = table[torch.clamp(rank, 0, Np - 1)]                        # (Np, 2W, SROW)
    me = table[:, None]
    over = torch.all((me[..., 4:7] <= cand[..., 8:11]) & (cand[..., 4:7] <= me[..., 8:11]), -1)
    ok = (over & (rank >= 0) & (rank < Np) & (cand[..., 7] > 0.5) & (me[..., 7] > 0.5)
          & (cand[..., 3] != me[..., 3]))
    diff = me[..., 0:3] - cand[..., 0:3]
    score = torch.where(ok, -dot3(diff, diff), -BIG)
    s = torch.sort(score, dim=1, descending=True, stable=True)
    picks = s.indices[:, :K]
    sel = torch.zeros((Np, deltas.shape[0]), dtype=torch.bool, device=dev)
    sel.scatter_(1, picks, True)
    return picks, s.values[:, :K] > -BIG / 2, sel


def window_mutual(table, picks, real, sel, window: int):
    """Plain mirror of B12's output step: (pidx, pok) in piece order. Slot k
    of sorted lane r names the piece at rank clamp(r + d, 0, Np - 1); it is
    live when real and lane r + d selected -d."""
    Np = table.shape[0]
    dev = table.device
    W = window
    d = torch.tensor(window_deltas(W), device=dev)[picks]              # (Np, K)
    rj = torch.arange(Np, device=dev)[:, None] + d
    rc = torch.clamp(rj, 0, Np - 1)
    ids = table[:, 11].contiguous().view(torch.int32)
    back = torch.where(d > 0, W + d - 1, -d - 1)
    live = real & sel[rc, back]
    o = ids.long()
    pidx = torch.empty_like(picks, dtype=torch.int32)
    pok = torch.empty_like(real)
    pidx[o] = ids[rc]
    pok[o] = live
    return pidx, pok


@functools.lru_cache(maxsize=None)
def _sorted_fns():
    """B12's three C entry points: codes, table pack, selection + mutual."""
    P, I = ctypes.c_void_p, ctypes.c_int
    return (_build.bind("surtr_broadphase_sorted_key", [P, I, P, I, P, P, P]),
            _build.bind("surtr_broadphase_sorted_pack", [P, I, P, I, P, I, P, I, P, P, I, P, P]),
            _build.bind("surtr_broadphase_sorted", [P, I, I, I, I, P, P, P, P, P, P]))


def _sorted_launch(centers, lo, hi, owner, valid, K, window):
    """B12 on the card: (pidx, pok, glue), glue = (codes, order, table) as
    ``sorted_glue`` gives them. Four launches and one ``torch.sort``; no
    other PyTorch op on the device, no host sync."""
    global sorted_launches, sorted_list_launches
    Np = centers.shape[0]
    dev = centers.device
    _check_inputs("broadphase_sorted kernel", centers, lo, hi, owner, valid, K)
    if K > 2 * window:
        raise ValueError(f"broadphase_sorted: K={K} > 2·window={2 * window}")
    if owner.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"broadphase_sorted kernel takes int32 or int64 owners, got {owner.dtype}")
    pidx = torch.empty((Np, K), dtype=torch.int32, device=dev)
    pok = torch.empty((Np, K), dtype=torch.bool, device=dev)
    codes = torch.empty((Np,), dtype=torch.int32, device=dev)
    if Np == 0:
        return pidx, pok, (codes, torch.empty((0,), dtype=torch.int64, device=dev),
                           torch.empty((0, SROW), dtype=torch.float32, device=dev))
    # Row-strided (Np, 3) views are read in place (the step hands in columns
    # of its (Np, 9) AABB table); bool and int tensors as they come.
    c, lo, hi = (t if t.stride(1) == 1 else t.contiguous() for t in (centers, lo, hi))
    own, val = owner.contiguous(), valid.contiguous()
    NW = (2 * window + 31) // 32
    table = torch.empty((Np, SROW), dtype=torch.float32, device=dev)
    variant = _sorted_variant(K, window)
    wide = 2 * window > 32767       # 32-bit picks
    picks = torch.empty((Np * K,), dtype=torch.int32 if wide else torch.int16, device=dev)
    masks = torch.empty((Np * NW,), dtype=torch.int32, device=dev)
    gbuf = (torch.empty((Np * list_bytes(K, window),), dtype=torch.uint8, device=dev)
            if variant == "list_scratch" else None)
    parts = torch.empty((6 * KEY_PARTS,), dtype=torch.float32, device=dev)
    stream = _build.stream_ptr(dev)
    key_fn, pack_fn, sweep_fn = _sorted_fns()
    _build.check(key_fn(c.data_ptr(), c.stride(0), val.data_ptr(), Np, parts.data_ptr(),
                        codes.data_ptr(), stream), "surtr_broadphase_sorted_key")
    order = torch.sort(codes, stable=True).indices
    _build.check(pack_fn(c.data_ptr(), c.stride(0), lo.data_ptr(), lo.stride(0), hi.data_ptr(),
                         hi.stride(0), own.data_ptr(), int(own.dtype == torch.int64),
                         val.data_ptr(), order.data_ptr(), Np, table.data_ptr(), stream),
                 "surtr_broadphase_sorted_pack")
    _build.check(sweep_fn(table.data_ptr(), Np, K, window, SORTED_VARIANTS.index(variant),
                          pidx.data_ptr(), pok.data_ptr(), picks.data_ptr(), masks.data_ptr(),
                          None if gbuf is None else gbuf.data_ptr(), stream),
                 "surtr_broadphase_sorted")
    sorted_launches += 1
    sorted_list_launches += variant != "warp"
    return pidx, pok, (codes, order, table)


def broadphase_sorted(centers, lo, hi, owner, valid, K: int, window: int):
    """Morton-window broadphase, mutual: (pidx (Np, K) i32, pok (Np, K)
    bool); the kernel for CUDA tensors, the plain version for CPU tensors."""
    if centers.is_cuda:
        return _sorted_launch(centers, lo, hi, owner, valid, K, window)[:2]
    if centers.device.type != "cpu":
        raise ValueError(f"broadphase_sorted: unsupported device {centers.device}")
    return broadphase_sorted_reference(centers, lo, hi, owner, valid, K, window)
