"""Tiled z-buffer raster with device dispatch (kernel B11,
``csrc/raster.cu``). Replaces the JAX package's ``rasterize_ids_pallas``
(surtr_tpu/render/raster_pallas.py).

The image is cut into 16 × 128 tiles. Triangles are sorted stably by the
tile of their bounding-box centre (invalid last) and packed into one
(T_pad, 10 + A) table of ax ay bx by cx cy za zb zc ok and the A G-buffer
columns, in chunks of 64 rows. Each chunk has a screen bounding box over
its valid triangles, and each tile the range [lo, hi) of chunks whose box
overlaps it. Per pixel, the depth is the smallest z = (w0·za + w1·zb) +
w2·zc over the covering triangles of the tile's overlapping chunks, walked
in order and replaced only on a strictly smaller z, which keeps the first
minimum: the winning id is the first such triangle in sorted order, mapped
back to the caller's order. Uncovered pixels keep depth ``BIG`` and id -1;
the G-buffer is the winner's attribute row, zeros on background.

``rasterize_ids_tiled`` builds the table with ``tile_table`` (for CUDA
tensors two glue launches around one ``torch.sort``, no host sync; for CPU
tensors the plain ``_tile_table``), then ``tile_raster`` launches the
kernel for CUDA tensors (or raises) and runs the plain version,
``tile_raster_reference``, for CPU tensors. The kernel spreads each tile's
live (tile, chunk) pairs over several CTAs and merges their partial results
by the packed key ``pack_key``; ``split_raster_reference`` is the plain
mirror of that split and merge, with ``tile_offsets`` and ``split_slots``
for the global variant's offsets and key slots.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from plainref import _build
from plainref.ops.linalg import div_rn

BIG = 3.4e38
TH, TW = 16, 128      # tile rows, tile columns
CHUNK = 64            # triangles per chunk

KEY_NONE = (1 << 63) - 1   # packed key of an untouched pixel, above every (z, id) key

launches = 0          # raster kernel launches since the last reset (main-path proof), both variants
general_launches = 0  # of which the global variant's (one a call)
glue_launches = 0     # glue calls (two launches each) since the last reset

RESIDENT_LIMIT = 10239   # tiles whose (tiles + 1) offsets fit the resident kernel's 40 KB
RESIDENT_TILES = 157     # the measured crossover: the resident kernel up to it
SLOTS_PER_SM = 8         # the global variant's key slots an SM: its CTAs of 256 threads at most


def _variant(ntiles: int) -> str:
    """"resident" (one launch, each CTA computes every tile's offsets into
    its shared memory: today's kernel) up to 157 tiles of 16 x 128, else
    "global" (the offsets computed once into device memory by two small
    launches, then one raster launch; a key slot a CTA for the tiles a
    slice boundary splits): every screen size has a variant. The resident
    kernel takes up to 10,239 tiles, but each of its CTAs counts every
    tile, and on an NVIDIA H100 the global variant was the faster from 200
    tiles on (render_512's shadow maps, tools/time_b9_b11.py
    --shadow-maps: a loss of 1-2 µs at 128 tiles, gains of 2 µs at 200
    and 0.4 ms at 8,192; 157 interpolates the crossover). Any number of
    G-buffer columns A is taken by both."""
    return "resident" if ntiles <= RESIDENT_TILES else "global"


def global_bytes(ntiles: int, slots: int) -> int:
    """Bytes of the global variant's scratch (``global_bytes`` in the
    kernel): the (ntiles + 1) int32 offsets rounded up to 16 bytes, then
    ``slots`` key images of 2,048 int64 keys and ``slots`` int32 counts."""
    return -(-(ntiles + 1) * 4 // 16) * 16 + slots * (TH * TW * 8 + 4)


@functools.lru_cache(maxsize=None)
def _slots(index: int) -> int:
    """Key slots the global variant gets on CUDA device ``index``: one for
    each CTA its grid can hold (the kernel checks its grid against it)."""
    return SLOTS_PER_SM * torch.cuda.get_device_properties(index).multi_processor_count


def _tile_table(sx, sy, sz, ok, W: int, H: int, attr_tab=None):
    """Sort, pack, chunk boxes and tile ranges of ``rasterize_ids_pallas``.

    Returns (attrs (T_pad, 10 + A), bbox (nblk, 4) bx0 bx1 by0 by1,
    rng (tiles, 2) int32, order (T,) int64, (nty, ntx))."""
    T = sx.shape[0]
    dev = sx.device
    A = 0 if attr_tab is None else attr_tab.shape[1]
    nty, ntx = -(-H // TH), -(-W // TW)

    # Tile of the bbox centre, ((a + b) + c) / 3 as jnp.mean; floor division
    # then clip, the clip done in float first (XLA saturates out-of-range
    # conversions, PyTorch does not).
    cx_mid = div_rn((sx[:, 0] + sx[:, 1]) + sx[:, 2], 3.0)
    cy_mid = div_rn((sy[:, 0] + sy[:, 1]) + sy[:, 2], 3.0)
    tx = torch.clamp(torch.floor_divide(cx_mid, float(TW)), 0, ntx - 1).to(torch.int32)
    ty = torch.clamp(torch.floor_divide(cy_mid, float(TH)), 0, nty - 1).to(torch.int32)
    key = torch.where(ok, ty * ntx + tx, 1 << 30)
    order = torch.argsort(key, stable=True)

    T_pad = -(-T // CHUNK) * CHUNK
    nblk = T_pad // CHUNK
    cols = [sx[:, 0], sy[:, 0], sx[:, 1], sy[:, 1], sx[:, 2], sy[:, 2],
            sz[:, 0], sz[:, 1], sz[:, 2], ok.to(sx.dtype)]
    attrs = torch.zeros((T_pad, 10 + A), dtype=torch.float32, device=dev)
    attrs[:T, :10] = torch.stack(cols, 1)[order]
    if A:
        attrs[:T, 10:] = attr_tab.to(torch.float32)[order]
    oks = attrs[:, 9] > 0.5

    def chunk_minmax(cs, lo: bool):
        fill = BIG if lo else -BIG
        v = torch.where(oks[:, None], attrs[:, cs], fill).reshape(nblk, CHUNK * 3)
        return v.amin(1) if lo else v.amax(1)

    xs, ys = [0, 2, 4], [1, 3, 5]
    bbox = torch.stack([chunk_minmax(xs, True), chunk_minmax(xs, False),
                        chunk_minmax(ys, True), chunk_minmax(ys, False)], 1)

    t = torch.arange(nty * ntx, device=dev)
    tx0 = (t % ntx).to(torch.float32) * TW
    ty0 = (t // ntx).to(torch.float32) * TH
    ov = ((bbox[None, :, 0] <= (tx0 + TW)[:, None]) & (bbox[None, :, 1] >= tx0[:, None])
          & (bbox[None, :, 2] <= (ty0 + TH)[:, None]) & (bbox[None, :, 3] >= ty0[:, None]))
    b = torch.arange(nblk, device=dev)[None]
    lo = torch.where(ov, b, nblk).amin(1)
    hi = torch.where(ov, b + 1, 0).amax(1)
    rng = torch.stack([lo, torch.maximum(hi, lo)], 1).to(torch.int32).contiguous()
    return attrs, bbox.contiguous(), rng, order, (nty, ntx)


def _chunk_pairs(bbox, rng, nty: int, ntx: int):
    """(tile, chunk) pairs the kernel evaluates: inside the tile's range and
    past the chunk-box reject, sorted by tile then chunk."""
    dev = bbox.device
    nblk = bbox.shape[0]
    t = torch.arange(nty * ntx, device=dev)
    x0 = (t % ntx).to(torch.float32) * TW
    y0 = (t // ntx).to(torch.float32) * TH
    b = torch.arange(nblk, device=dev)[None]
    live = ((b >= rng[:, :1]) & (b < rng[:, 1:])
            & (bbox[None, :, 0] <= (x0 + TW)[:, None]) & (bbox[None, :, 1] >= x0[:, None])
            & (bbox[None, :, 2] <= (y0 + TH)[:, None]) & (bbox[None, :, 3] >= y0[:, None]))
    return torch.nonzero(live, as_tuple=True)


def pack_key(z, ids):
    """The merge key of a (z, id) pair: float32 bits of z above the id, as
    int64. For z in (0, 1) (subnormals included) and BIG, and 0 <= id <
    2^31, keys order as (z, id) lexicographically: the smallest key is the
    smallest z and, on equal z, the first triangle."""
    return (z.to(torch.float32).view(torch.int32).to(torch.int64) << 32) | ids.to(torch.int64)


def _pair_bests(attrs, tile_of, chunk_of, ntx: int, pairs_per_batch: int = 64):
    """Per (tile, chunk) pair and tile pixel (tile-major rows of 2,048): the
    chunk's smallest covering z in (0, 1) (BIG where none) and the first
    triangle holding it, as the kernel's walk of one chunk finds them."""
    dev = attrs.device
    PX = TH * TW
    k = torch.arange(PX, device=dev)
    zbest = torch.full((tile_of.shape[0], PX), BIG, dtype=torch.float32, device=dev)
    ibest = torch.zeros((tile_of.shape[0], PX), dtype=torch.int64, device=dev)
    for s in range(0, tile_of.shape[0], pairs_per_batch):
        tt, cc = tile_of[s:s + pairs_per_batch], chunk_of[s:s + pairs_per_batch]
        py = ((k // TW)[None] + (tt // ntx)[:, None] * TH).to(torch.float32)[:, None] + 0.5
        px = ((k % TW)[None] + (tt % ntx)[:, None] * TW).to(torch.float32)[:, None] + 0.5
        rows = (cc[:, None] * CHUNK + torch.arange(CHUNK, device=dev)[None])   # (n, 64)
        blk = attrs[rows]                                                      # (n, 64, 10+A)
        col = lambda j: blk[:, :, j, None]                                     # noqa: E731
        ax, ay, bx, by, cx, cy = (col(j) for j in range(6))
        za, zb, zc = col(6), col(7), col(8)
        okb = col(9) > 0.5
        area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
        live = okb & (torch.abs(area) > 1e-12)
        inv_area = torch.where(torch.abs(area) > 1e-12, 1.0 / area, 0.0)
        e0 = (cx - bx) * (py - by) - (cy - by) * (px - bx)                     # (n, 64, PX)
        e1 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx)
        e2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
        w0, w1, w2 = e0 * inv_area, e1 * inv_area, e2 * inv_area
        z = (w0 * za + w1 * zb) + w2 * zc
        cov = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & live & (z > 0) & (z < 1)
        z = torch.where(cov, z, BIG)
        zb_, ib_ = torch.min(z, dim=1)                    # first minimum in the chunk
        zbest[s:s + pairs_per_batch] = zb_
        ibest[s:s + pairs_per_batch] = cc[:, None] * CHUNK + ib_
    return zbest, ibest


def _image(zt, tid, attrs, nty: int, ntx: int, H: int, W: int, A: int):
    """Tile-major (tiles, 2,048) depth and sorted-domain ids (-1 =
    background) → (depth (H, W), tid (H, W) int32, gbuf (H, W, A) or
    None)."""
    Hp, Wp = nty * TH, ntx * TW
    depth = zt.reshape(nty, ntx, TH, TW).permute(0, 2, 1, 3).reshape(Hp, Wp)[:H, :W]
    tid = tid.reshape(nty, ntx, TH, TW).permute(0, 2, 1, 3).reshape(Hp, Wp)[:H, :W]
    gbuf = None
    if A:
        gbuf = torch.where((tid >= 0)[..., None], attrs[torch.clamp(tid, min=0), 10:], 0.0)
    return depth.contiguous(), tid.to(torch.int32).contiguous(), gbuf


def tile_raster_reference(attrs, bbox, rng, nty: int, ntx: int, H: int, W: int, A: int,
                          pairs_per_batch: int = 64):
    """Plain B11 on the packed table: (depth (H, W), sorted-domain id (H, W)
    int32, gbuf (H, W, A) or None).

    Per (tile, chunk) pair the chunk's best z and first best triangle per
    pixel, as the kernel computes them; per tile the smallest over its
    pairs, the first pair in chunk order on ties. That is the kernel's walk
    (replace on strictly smaller), evaluated in batches of pairs."""
    dev = attrs.device
    PX = TH * TW
    ntiles = nty * ntx
    tile_of, chunk_of = _chunk_pairs(bbox, rng, nty, ntx)
    zbest, ibest = _pair_bests(attrs, tile_of, chunk_of, ntx, pairs_per_batch)
    # Per tile: the smallest z over its pairs; the first pair holding it.
    zt = torch.full((ntiles, PX), BIG, dtype=torch.float32, device=dev)
    zt.scatter_reduce_(0, tile_of[:, None].expand(-1, PX), zbest, "amin")
    npair = tile_of.shape[0]
    first = torch.full((ntiles, PX), npair, dtype=torch.int64, device=dev)
    pidx = torch.arange(npair, device=dev)[:, None].expand(-1, PX)
    hold = zbest == zt[tile_of]
    first.scatter_reduce_(0, tile_of[:, None].expand(-1, PX), torch.where(hold, pidx, npair),
                          "amin")
    ibest_ext = torch.cat([ibest, torch.zeros((1, PX), dtype=torch.int64, device=dev)])
    tid = torch.gather(ibest_ext, 0, first)
    tid = torch.where(zt < BIG, tid, -1)
    return _image(zt, tid, attrs, nty, ntx, H, W, A)


def tile_offsets(bbox, rng, nty: int, ntx: int):
    """The tile-major list's offsets, (tiles + 1) int64: tile t's live
    pairs are [start[t], start[t + 1]) (the global variant's count and
    scan launches; the resident kernel's step 1)."""
    tile_of, _ = _chunk_pairs(bbox, rng, nty, ntx)
    cnt = torch.bincount(tile_of, minlength=nty * ntx)
    return torch.cat([cnt.new_zeros(1), torch.cumsum(cnt, 0)])


def split_slots(start, slices: int):
    """The global variant's key slot of each tile, (tiles,) int64: for a
    tile that a slice boundary c·L // slices (0 < c < slices) splits, the
    first such c, ceil((start[t] + 1)·slices / L); -1 for a tile that lies
    whole in one slice (or has no pair)."""
    L = int(start[-1])
    if L == 0:
        return torch.full_like(start[:-1], -1)
    slot = ((start[:-1] + 1) * slices + L - 1) // L
    bound = (slot * L) // slices          # that boundary's first pair
    return torch.where((slot < slices) & (bound < start[1:]), slot, -1)


def split_raster_reference(attrs, bbox, rng, nty: int, ntx: int, H: int, W: int, A: int,
                           slices: int, slot_keys: bool = False):
    """Plain mirror of the kernel's split and merge: the tile-major list of
    live (tile, chunk) pairs cut into ``slices`` equal contiguous slices
    (slice c holds pairs [c·L // slices, (c + 1)·L // slices)); each slice
    walks its pairs in order, replacing a pixel only on a strictly smaller
    z below 1. A tile that lies whole in one slice is written directly; a
    split tile's partials merge by the smallest ``pack_key`` in a key
    image: the tile's own (the resident kernel) or, with ``slot_keys``, the
    slot ``split_slots`` gives it, one of ``slices`` (the global variant,
    whose scratch has a slot a CTA). Returns what ``tile_raster_reference``
    returns."""
    dev = attrs.device
    PX = TH * TW
    tile_of, chunk_of = _chunk_pairs(bbox, rng, nty, ntx)
    zbest, ibest = _pair_bests(attrs, tile_of, chunk_of, ntx)
    L = tile_of.shape[0]
    start = tile_offsets(bbox, rng, nty, ntx)
    slot = split_slots(start, slices) if slot_keys else torch.arange(nty * ntx, device=dev)
    keys = torch.full((slices if slot_keys else nty * ntx, PX), KEY_NONE, dtype=torch.int64,
                      device=dev)
    merged = torch.zeros(nty * ntx, dtype=torch.int64, device=dev)   # pairs merged a tile
    zt = torch.full((nty * ntx, PX), BIG, dtype=torch.float32, device=dev)
    tid = torch.full((nty * ntx, PX), -1, dtype=torch.int64, device=dev)
    for c in range(slices):
        p, s1 = c * L // slices, (c + 1) * L // slices
        while p < s1:
            t = int(tile_of[p])
            p0 = p
            thr = torch.ones(PX, dtype=torch.float32, device=dev)
            ids = torch.full((PX,), -1, dtype=torch.int64, device=dev)
            while p < s1 and int(tile_of[p]) == t:
                take = zbest[p] < thr
                thr = torch.where(take, zbest[p], thr)
                ids = torch.where(take, ibest[p], ids)
                p += 1
            cnt = int(start[t + 1] - start[t])
            if p - p0 == cnt:                       # whole: written directly
                zt[t] = torch.where(ids >= 0, thr, BIG)
                tid[t] = ids
                continue
            k = int(slot[t])
            assert 0 <= k < keys.shape[0], (t, k)
            part = torch.where(ids >= 0, pack_key(thr, torch.clamp(ids, min=0)), KEY_NONE)
            keys[k] = torch.minimum(keys[k], part)
            merged[t] += p - p0
            if int(merged[t]) == cnt:               # the part that completes the tile
                hit = keys[k] != KEY_NONE
                zt[t] = torch.where(hit, (keys[k] >> 32).to(torch.int32).view(torch.float32),
                                    BIG)
                tid[t] = torch.where(hit, keys[k] & 0xFFFFFFFF, -1)
    return _image(zt, tid, attrs, nty, ntx, H, W, A)


@functools.lru_cache(maxsize=None)
def _fns():
    """B11's three C entry points: the glue's key and pack, the raster."""
    P, I = ctypes.c_void_p, ctypes.c_int
    return (_build.bind("surtr_raster_key", [P, P, P] + [I] * 4 + [P, P, P, P]),
            _build.bind("surtr_raster_pack", [P] * 5 + [I, P] + [I] * 4 + [P] * 5),
            _build.bind("surtr_raster", [P] * 4 + [I] + [P] * 4 + [I] * 7 + [P, P]))


def _glue_kernel(sx, sy, sz, ok, W: int, H: int, attr_tab=None):
    """``_tile_table`` on the card: the centre-tile key (first launch), one
    stable ``torch.sort``, then the sorted table, the chunk boxes and the
    tile ranges (second launch). No host sync."""
    global glue_launches
    T = sx.shape[0]
    dev = sx.device
    A = 0 if attr_tab is None else attr_tab.shape[1]
    for t in (sx, sy, sz):
        if t.shape != (T, 3) or t.device != dev:
            raise ValueError("raster glue takes (T, 3) screen x, y and z on one device")
    if ok.shape != (T,) or ok.dtype != torch.bool or T == 0:
        raise ValueError("raster glue takes T >= 1 triangles and an (T,) bool mask")
    nty, ntx = -(-H // TH), -(-W // TW)
    ntiles = nty * ntx
    nblk = -(-T // CHUNK)
    D = 10 + A
    sx, sy, sz = (t.to(torch.float32).contiguous() for t in (sx, sy, sz))
    okc = ok.contiguous()
    attr = attr_tab.to(torch.float32).contiguous() if A else None
    # int32 scratch: sort key (T), tile ranges (ntiles, 2), the pack's CTA
    # count; float32: chunk boxes (nblk, 4), then the table (16-byte aligned).
    ints = torch.empty((T + 2 * ntiles + 1,), dtype=torch.int32, device=dev)
    flts = torch.empty((4 * nblk + nblk * CHUNK * D,), dtype=torch.float32, device=dev)
    key, rng, done = ints[:T], ints[T:T + 2 * ntiles], ints[T + 2 * ntiles:]
    bbox, attrs = flts[:4 * nblk].view(nblk, 4), flts[4 * nblk:].view(nblk * CHUNK, D)
    stream = _build.stream_ptr(dev)
    key_fn, pack_fn, _ = _fns()
    _build.check(key_fn(sx.data_ptr(), sy.data_ptr(), okc.data_ptr(), T, ntx, nty, nblk,
                        key.data_ptr(), rng.data_ptr(), done.data_ptr(), stream),
                 "surtr_raster_key")
    order = torch.sort(key, stable=True).indices
    _build.check(pack_fn(sx.data_ptr(), sy.data_ptr(), sz.data_ptr(), okc.data_ptr(),
                         attr.data_ptr() if A else None, A, order.data_ptr(), T, nblk, ntx, nty,
                         attrs.data_ptr(), bbox.data_ptr(), rng.data_ptr(), done.data_ptr(),
                         stream), "surtr_raster_pack")
    glue_launches += 1
    return attrs, bbox, rng.view(ntiles, 2), order, (nty, ntx)


def tile_table(sx, sy, sz, ok, W: int, H: int, attr_tab=None):
    """Sort, pack, chunk boxes and tile ranges (what ``_tile_table``
    returns): the glue kernels for CUDA tensors, ``_tile_table`` for CPU
    tensors."""
    if sx.is_cuda:
        return _glue_kernel(sx, sy, sz, ok, W, H, attr_tab)
    if sx.device.type != "cpu":
        raise ValueError(f"tile_table: unsupported device {sx.device}")
    return _tile_table(sx, sy, sz, ok, W, H, attr_tab)


def _kernel(attrs, bbox, rng, nty: int, ntx: int, H: int, W: int, A: int, order=None):
    global launches, general_launches
    if attrs.dtype != torch.float32 or attrs.dim() != 2 or attrs.shape[1] != 10 + A \
            or attrs.shape[0] % CHUNK or bbox.shape != (attrs.shape[0] // CHUNK, 4) \
            or rng.shape != (nty * ntx, 2) or rng.dtype != torch.int32 \
            or not (attrs.is_contiguous() and bbox.is_contiguous() and rng.is_contiguous()):
        raise ValueError("raster kernel takes a contiguous (T_pad, 10 + A) float32 table, "
                         "(T_pad / 64, 4) chunk boxes and (tiles, 2) int32 ranges")
    ntiles = nty * ntx
    glob = _variant(ntiles) == "global"
    if bbox.data_ptr() % 16:
        bbox = bbox.clone()
    dev = attrs.device
    if order is not None:
        order = order.to(torch.int64).contiguous()
    depth = torch.empty((H, W), dtype=torch.float32, device=dev)
    tid = torch.empty((H, W), dtype=torch.int32, device=dev)
    gbuf = torch.empty((H, W, A), dtype=torch.float32, device=dev) if A else None
    slots = _slots(torch.cuda.current_device() if dev.index is None else dev.index) if glob else 0
    size = global_bytes(ntiles, slots) if glob else ntiles * (TH * TW * 8 + 4)
    scratch = torch.empty((size,), dtype=torch.uint8, device=dev)
    n = ctypes.c_int(0)
    rc = _fns()[2](attrs.data_ptr(), bbox.data_ptr(), rng.data_ptr(),
                   None if order is None else order.data_ptr(),
                   0 if order is None else order.shape[0], depth.data_ptr(), tid.data_ptr(),
                   gbuf.data_ptr() if A else None, scratch.data_ptr(), H, W, ntx, nty, A,
                   int(glob), slots, ctypes.byref(n), _build.stream_ptr(dev))
    _build.check(rc, "surtr_raster")
    launches += n.value
    if glob:
        general_launches += n.value
    return depth, tid, gbuf


def _finish(order, depth, tid, gbuf):
    """Sorted-domain ids back to the caller's order (-1 stays -1)."""
    T = order.shape[0]
    order_ext = torch.cat([order, torch.full((1,), -1, dtype=order.dtype, device=order.device)])
    tid = order_ext[torch.where((tid >= 0) & (tid < T), tid, T).long()].to(torch.int32)
    return depth, tid, gbuf


def tile_raster(attrs, bbox, rng, nty: int, ntx: int, H: int, W: int, A: int, order=None):
    """B11 on the packed table: (depth, tid, gbuf or None) with sorted-domain
    ids, or with ``order`` (the table's sort) ids in the caller's order. The
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if attrs.is_cuda:
        return _kernel(attrs, bbox, rng, nty, ntx, H, W, A, order)
    if attrs.device.type != "cpu":
        raise ValueError(f"tile_raster: unsupported device {attrs.device}")
    out = tile_raster_reference(attrs, bbox, rng, nty, ntx, H, W, A)
    return out if order is None else _finish(order, *out)


def rasterize_ids_tiled(sx, sy, sz, ok, W: int, H: int, attr_tab=None):
    """Z-buffer raster of screen-space triangles: sx, sy, sz (T, 3) screen
    x, y and NDC depth, ok (T,) bool. Returns (depth (H, W), tid (H, W)
    int32 in the caller's order, -1 = background), and gbuf (H, W, A) =
    attr_tab[tid] (zeros on background) when ``attr_tab`` (T, A) is given."""
    A = 0 if attr_tab is None else attr_tab.shape[1]
    attrs, bbox, rng, order, (nty, ntx) = tile_table(sx, sy, sz, ok, W, H, attr_tab)
    depth, tid, gbuf = tile_raster(attrs, bbox, rng, nty, ntx, H, W, A, order)
    return (depth, tid) if gbuf is None else (depth, tid, gbuf)
