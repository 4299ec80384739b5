"""Kernel B11's split and merge, and its glue, on the CPU.

The kernel (``csrc/raster.cu``) cuts the tile-major list of live (tile,
chunk) pairs into contiguous slices, one per CTA, and merges the slices'
partial results per pixel by the packed key (float bits of z ‖ id).
``raster_cuda.split_raster_reference`` mirrors that schedule in plain
PyTorch; here it must equal the plain raster ``tile_raster_reference`` bit
for bit (depth, ids and G-buffer) for 1, 2, 3 and 7 slices, on
test_torch_render.py's B11 tables and on a dense tile whose equal-z
duplicates straddle chunk and slice boundaries. The key must order as (z,
id). The glue's per-chunk folding of the tile ranges (what its pack launch
does with atomics) must give ``_tile_table``'s table and ranges. Inputs
come from numpy seeds. The plain raster itself is held against the JAX
kernel in test_torch_render.py.
"""

import numpy as np
import pytest
import torch

from surtr_tpu_torch.render import raster_cuda as rc
from torch_threads import bounded_threads  # noqa: F401 (autouse)

RW, RH = 256, 64
# test_torch_render.py's B11 tables: name → (seed, T, with G-buffer).
RASTER_CASES = {
    "random": (3, 160, False),
    "random_gbuf": (3, 160, True),
    "T40_gbuf": (5, 40, True),
    "T100": (6, 100, False),
    "none_valid": (7, 96, True),
}
CASES = [*RASTER_CASES, "dense_tile"]
# Indices of the dense tile's equal-depth copies: chunk boundaries at 64,
# 128, 192; the slices of 2, 3 and 7 cut the dense tile's pairs in between.
FLAT_COPIES = (5, 63, 64, 130, 200, 260)
DUP_COPIES = (127, 128, 191, 192)


def _raster_inputs(name):
    """test_torch_render.py's generator: random triangles, one covering the
    screen at depth 0.9, an exact duplicate, an invalid one, one off
    screen."""
    seed, T, gbuf = RASTER_CASES[name]
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-20, RW + 20, (T, 1))
    cy = rng.uniform(-10, RH + 10, (T, 1))
    sx = (cx + rng.normal(0, 25, (T, 3))).astype(np.float32)
    sy = (cy + rng.normal(0, 12, (T, 3))).astype(np.float32)
    sz = rng.uniform(-0.1, 1.1, (T, 3)).astype(np.float32)
    ok = rng.uniform(size=T) > 0.05
    sx[0], sy[0], sz[0] = [-10, 3 * RW, -10], [-10, -10, 3 * RH], [0.9, 0.9, 0.9]
    sx[1], sy[1], sz[1] = [30, 90, 50], [10, 15, 50], [0.05, 0.05, 0.05]
    sx[2], sy[2], sz[2] = sx[1], sy[1], sz[1]
    ok[:3] = True
    ok[3] = False
    sx[4] += 10 * RW
    if name == "none_valid":
        ok[:] = False
    attr = rng.normal(size=(T, 7)).astype(np.float32) if gbuf else None
    return sx, sy, sz, ok, attr


def _dense_tile():
    """400 triangles centred in tile (0, 0), so its chunk range holds ~7
    live chunks; copies of one tile-covering triangle at constant depth 0.5
    and of one random triangle, at the indices above; 5% invalid."""
    rng = np.random.default_rng(9)
    T = 400
    c = rng.uniform([8.0, 2.0], [120.0, 14.0], (T, 1, 2))
    xy = c + rng.normal(0, [30.0, 6.0], (T, 3, 2))
    xy = (xy - xy.mean(1, keepdims=True) + c).astype(np.float32)
    sz = rng.uniform(0.05, 0.95, (T, 3)).astype(np.float32)
    ok = rng.uniform(size=T) > 0.05
    for i in FLAT_COPIES:
        xy[i] = [[-200.0, -40.0], [300.0, -40.0], [64.0, 80.0]]
        sz[i] = 0.5
        ok[i] = True
    for i in DUP_COPIES:
        xy[i], sz[i], ok[i] = xy[10], sz[10], True
    ok[10] = True
    attr = rng.normal(size=(T, 7)).astype(np.float32)
    return xy[..., 0], xy[..., 1], sz, ok, attr


def _inputs(name):
    return _dense_tile() if name == "dense_tile" else _raster_inputs(name)


def _table(name):
    sx, sy, sz, ok, attr = (None if a is None else torch.as_tensor(a) for a in _inputs(name))
    return rc._tile_table(sx, sy, sz, ok, RW, RH, attr), 0 if attr is None else attr.shape[1]


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("slices", [1, 2, 3, 7])
@pytest.mark.parametrize("name", CASES)
def test_split_merge_matches_plain_raster(name, slices):
    (attrs, bbox, rng, order, (nty, ntx)), A = _table(name)
    want = rc.tile_raster_reference(attrs, bbox, rng, nty, ntx, RH, RW, A)
    got = rc.split_raster_reference(attrs, bbox, rng, nty, ntx, RH, RW, A, slices)
    for what, g, w in zip(("depth", "tid", "gbuf"), got, want):
        assert (g is None) == (w is None), what
        if g is not None:
            assert torch.equal(_bits(g), _bits(w)), what
    if name == "dense_tile":
        tiles, _ = rc._chunk_pairs(bbox, rng, nty, ntx)
        assert int(torch.bincount(tiles).max()) >= 6       # one dense tile
        ids = order[want[1][want[1] >= 0].long()]
        # The first constant-depth copy wins where the copies are in front;
        # the later ones never do.
        assert (ids == FLAT_COPIES[0]).any()
        assert not any((ids == i).any() for i in FLAT_COPIES[1:])


def test_pack_key_orders_like_z_then_id():
    rng = np.random.default_rng(12)
    z = np.concatenate([
        rng.uniform(0, 1, 200), [1e-45, 3e-45, 1e-40, 1e-39, 1.1754942e-38, 1.1754944e-38],
        [np.nextafter(np.float32(1), np.float32(0)), rc.BIG],
    ]).astype(np.float32)
    z = np.concatenate([z, z[:50]])                 # equal z, other ids
    z = z[z > 0]
    ids = rng.permutation(z.shape[0]).astype(np.int64) * 1000
    keys = rc.pack_key(torch.as_tensor(z), torch.as_tensor(ids))
    got = torch.argsort(keys, stable=True).numpy()
    want = np.lexsort((ids, z))
    np.testing.assert_array_equal(got, want)
    assert int(keys.max()) < rc.KEY_NONE


def _glue_fold(attrs, nty, ntx):
    """The glue's pack launch, one chunk at a time: the chunk's box over its
    valid rows, then atomicMin / atomicMax of the chunk into the range of
    every tile the box meets (ranges start at (nblk, 0)); last, a tile that
    no box met gets (nblk, nblk)."""
    nblk = attrs.shape[0] // rc.CHUNK
    box = np.zeros((nblk, 4), np.float32)
    rng = np.tile(np.array([nblk, 0], np.int64), (nty * ntx, 1))
    a = attrs.numpy()
    for b in range(nblk):
        rows = a[b * rc.CHUNK:(b + 1) * rc.CHUNK]
        rows = rows[rows[:, 9] > 0.5]
        xs, ys = rows[:, [0, 2, 4]], rows[:, [1, 3, 5]]
        box[b] = ([xs.min(), xs.max(), ys.min(), ys.max()] if len(rows)
                  else [rc.BIG, -rc.BIG, rc.BIG, -rc.BIG])
        for t in range(nty * ntx):
            tx0, ty0 = np.float32(t % ntx) * rc.TW, np.float32(t // ntx) * rc.TH
            if (box[b, 0] <= tx0 + rc.TW and box[b, 1] >= tx0 and box[b, 2] <= ty0 + rc.TH
                    and box[b, 3] >= ty0):
                rng[t] = [min(rng[t, 0], b), max(rng[t, 1], b + 1)]
    rng[:, 1] = np.maximum(rng[:, 1], rng[:, 0])
    return box, rng


@pytest.mark.parametrize("name", CASES)
def test_glue_fold_matches_tile_table(name):
    sx, sy, sz, ok, attr = _inputs(name)
    (attrs, bbox, rng, order, (nty, ntx)), _ = _table(name)
    # The key launch: centre tile in float32 ((a + b) + c) / 3, floor
    # division, clamp; invalid last; one stable sort.
    f = np.float32
    cx = ((sx[:, 0] + sx[:, 1]) + sx[:, 2]) / f(3)
    cy = ((sy[:, 0] + sy[:, 1]) + sy[:, 2]) / f(3)
    tx = np.clip(np.floor(cx / f(rc.TW)), 0, ntx - 1).astype(np.int64)
    ty = np.clip(np.floor(cy / f(rc.TH)), 0, nty - 1).astype(np.int64)
    key = np.where(ok, ty * ntx + tx, 1 << 30)
    np.testing.assert_array_equal(order.numpy(), np.argsort(key, kind="stable"))
    # The pack launch's rows, boxes and ranges.
    T = sx.shape[0]
    s = order.numpy()
    rows = np.stack([sx[s, 0], sy[s, 0], sx[s, 1], sy[s, 1], sx[s, 2], sy[s, 2],
                     sz[s, 0], sz[s, 1], sz[s, 2], ok[s].astype(np.float32)], 1)
    np.testing.assert_array_equal(attrs[:T, :10].numpy(), rows)
    assert not attrs[T:].any()
    if attr is not None:
        np.testing.assert_array_equal(attrs[:T, 10:].numpy(), attr[s])
    box, want_rng = _glue_fold(attrs, nty, ntx)
    np.testing.assert_array_equal(bbox.numpy(), box)
    np.testing.assert_array_equal(rng.numpy(), want_rng)


# The global variant (screens past ``RESIDENT_TILES``): its offsets in
# device memory and one key slot a CTA for the tiles a slice boundary
# splits. The "wide" screen has 48 tiles and is taken past a threshold
# lowered to 16 tiles; 1,056 slices are the card's grid (8 CTAs on each of
# 132 SMs), more slices than pairs.
WIDE_W, WIDE_H = 1024, 96


def _wide_table():
    rng = np.random.default_rng(21)
    T = 300
    c = rng.uniform([-30.0, -10.0], [WIDE_W + 30.0, WIDE_H + 10.0], (T, 1, 2))
    xy = (c + rng.normal(0, [60.0, 15.0], (T, 3, 2))).astype(np.float32)
    sz = rng.uniform(-0.1, 1.1, (T, 3)).astype(np.float32)
    ok = rng.uniform(size=T) > 0.05
    for i in (17, 80, 150):                     # equal-depth copies across chunks
        xy[i], sz[i], ok[i] = xy[3], sz[3], True
    attr = torch.as_tensor(rng.normal(size=(T, 7)).astype(np.float32))
    tab = rc._tile_table(torch.as_tensor(xy[..., 0]), torch.as_tensor(xy[..., 1]),
                         torch.as_tensor(sz), torch.as_tensor(ok), WIDE_W, WIDE_H, attr)
    return tab, WIDE_H, WIDE_W, 7


def _any_table(name):
    if name == "wide":
        return _wide_table()
    tab, A = _table(name)
    return tab, RH, RW, A


@pytest.mark.parametrize("slices", [2, 7, 1056])
@pytest.mark.parametrize("name", ["random_gbuf", "dense_tile", "wide"])
def test_global_slot_merge_matches_plain_raster(name, slices, monkeypatch):
    """The global variant's schedule: offsets by ``tile_offsets``, split
    tiles merged in the slots ``split_slots`` gives, bit for bit the plain
    raster; the slots are distinct, within the grid, and each is the first
    slice boundary strictly inside its tile."""
    (attrs, bbox, rng, order, (nty, ntx)), H, W, A = _any_table(name)
    if name == "wide":
        monkeypatch.setattr(rc, "RESIDENT_TILES", 16)
        assert rc._variant(nty * ntx) == "global"
    want = rc.tile_raster_reference(attrs, bbox, rng, nty, ntx, H, W, A)
    got = rc.split_raster_reference(attrs, bbox, rng, nty, ntx, H, W, A, slices, slot_keys=True)
    for what, g, w in zip(("depth", "tid", "gbuf"), got, want):
        assert torch.equal(_bits(g), _bits(w)), what
    start = rc.tile_offsets(bbox, rng, nty, ntx)
    tiles, _ = rc._chunk_pairs(bbox, rng, nty, ntx)
    np.testing.assert_array_equal(start.numpy(), np.concatenate(
        [[0], np.cumsum(np.bincount(tiles.numpy(), minlength=nty * ntx))]))
    slot = rc.split_slots(start, slices).numpy()
    L = int(start[-1])
    bounds = np.array([c * L // slices for c in range(1, slices)])
    for t in range(nty * ntx):
        inside = np.nonzero((bounds > int(start[t])) & (bounds < int(start[t + 1])))[0]
        assert slot[t] == (inside[0] + 1 if len(inside) else -1), t
    split = slot[slot >= 0]
    assert len(np.unique(split)) == len(split) and (split < slices).all()
    if slices == 7:
        assert len(split) > 0                   # a split tile merges through a slot
