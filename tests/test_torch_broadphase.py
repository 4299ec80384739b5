"""Kernels B6 and B12's plain versions (``broadphase_cuda.broadphase_exact``
and ``broadphase_sorted`` on CPU tensors, the CPU sides of
``csrc/broadphase_exact.cu`` and ``csrc/broadphase_sorted.cu``) against the
JAX package's ``broadphase_exact_pallas`` and ``broadphase_sorted_pallas``
in interpret mode (B12 at K, W = 4, 8; 8, 32 and the K = 2W of 16, 8; on
the tie-heavy lattice past the warp selection's limits, 32, 32 and 48, 32,
against the Pallas kernel's XLA original), B6's
glue (its chunk ranges) against the ranges the JAX wrapper hands its
kernel, B12's glue mirror (``sorted_glue``: codes, order, sorted table)
against the JAX wrapper's sorted pack and order, B12's selection and mutual
mirrors against ``morton_window_sweep`` and the plain version, the list
selection's round order (per-lane sorted lists, head-of-list warp maxima,
lowest candidate on ties) against the selection mirror, the Morton
codes, and the broadphase dispatch of ``physics_step``.

Tolerances: none. B6's keys are integers (quantized d² and the piece id)
and are compared slot for slot with pidx, pok, key_ji and θ; B12's live
slots (partner and flag) exactly, as tests/test_broadphase_pallas.py
compares the Pallas kernel with its XLA original (filler slots name
different pieces in the two: the XLA clamp rule here, the lane roll
there).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surtr_tpu.physics import broadphase_pallas as jbp
from surtr_tpu.physics.step import _broadphase as j_block_sweep
from surtr_tpu.physics.step import _broadphase_sorted as j_window_sweep
from surtr_tpu.physics.step import _morton as j_morton
from surtr_tpu_torch import workload
from surtr_tpu_torch.physics import broadphase_cuda as bp
from surtr_tpu_torch.physics import step as tstep
from surtr_tpu_torch.physics.broadphase import morton, morton_window_sweep
from surtr_tpu_torch.physics.scene import build_scene
from torch_threads import bounded_threads  # noqa: F401 (autouse)


def _random_boxes(n=700, seed=5, invalid=0.05, owner=None):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    half = rng.uniform(0.2, 0.6, (n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) > invalid
    own = np.arange(n, dtype=np.int32) if owner is None else owner
    return c, c - half, c + half, own.astype(np.int32), valid


def _lattice(side=9, half=0.52):
    g = np.arange(side, dtype=np.float32) * 1.02
    c = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    n = len(c)
    h = np.full((n, 3), half, np.float32)
    return c, c - h, c + h, np.arange(n, dtype=np.int32), np.ones(n, bool)


EXACT_CASES = {
    "random700": _random_boxes(),
    "lattice9": _lattice(),
    "shared_owners": _random_boxes(300, seed=7, invalid=0.2, owner=np.arange(300) // 2),
    "fewer_than_k": _random_boxes(40, seed=9, invalid=0.1),
}


def _jax_exact(args, K):
    """The JAX wrapper's outputs and the chunk ranges it gives its kernel."""
    seen = {}
    real = jbp.pl.pallas_call

    def recording(kernel, **kw):
        call = real(kernel, **kw)

        def run(*ops):
            seen["rng"] = np.asarray(ops[0])
            return call(*ops)
        return run

    jbp.pl.pallas_call = recording
    try:
        pidx, pok, (key_ji, theta) = jbp.broadphase_exact_pallas(
            *(jnp.asarray(a) for a in args), K, interpret=True)
    finally:
        jbp.pl.pallas_call = real
    return [np.asarray(a) for a in (pidx, pok, key_ji, theta)], seen["rng"]


@pytest.fixture(scope="module", params=list(EXACT_CASES))
def exact_case(request):
    args = EXACT_CASES[request.param]
    K = 8
    want, rng = _jax_exact(args, K)
    before = bp.exact_launches
    pidx, pok, (key_ji, theta) = bp.broadphase_exact(*(torch.as_tensor(a) for a in args), K)
    assert bp.exact_launches == before            # CPU tensors: the plain version
    got = [t.numpy() for t in (pidx, pok, key_ji, theta)]
    return args, K, got, want, rng


def test_exact_matches_pallas_slot_for_slot(exact_case):
    _, _, got, want, _ = exact_case
    for name, g, w in zip(("pidx", "pok", "key_ji", "theta"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[1].any()


def test_exact_empty_slots_keep_the_sentinel(exact_case):
    args, K, got, _, _ = exact_case
    bits = bp.id_bits(len(args[0]))
    pidx, pok = got[0], got[1]
    assert (pidx[~pok] == (1 << bits) - 1).all()
    assert (~pok).any()                           # invalid rows at least


def test_exact_chunk_ranges_match_and_cover(exact_case):
    args, K, _, _, jrng = exact_case
    t = [torch.as_tensor(a) for a in args]
    packR, cab, rng = bp.exact_glue(*t)
    np.testing.assert_array_equal(rng.numpy(), jrng)
    # Every overlapping pair's chunk lies in its block's range.
    c, lo, hi, owner, valid = args
    n = len(c)
    order = packR[:n, 11].long().numpy()
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    over = np.all((lo[:, None] <= hi[None]) & (lo[None] <= hi[:, None]), -1)
    over &= valid[:, None] & valid[None] & (owner[:, None] != owner[None])
    np.fill_diagonal(over, False)
    i, j = np.nonzero(over)
    blk, chj = rank[i] // 128, rank[j] // bp.CHUNK
    r = rng.numpy()
    assert ((r[blk, 0] <= chj) & (chj < r[blk, 1])).all()


def _overlaps(args):
    """(i, j) of every ordered pair that produces a key."""
    c, lo, hi, owner, valid = args
    over = np.all((lo[:, None] <= hi[None]) & (lo[None] <= hi[:, None]), -1)
    over &= valid[:, None] & valid[None] & (owner[:, None] != owner[None])
    np.fill_diagonal(over, False)
    return np.nonzero(over)


def test_tile_schedule_covers_every_overlap(exact_case):
    """The kernel's walk: every overlapping pair's row tile is visited by
    the query tile of its piece, and its row is among the rows tested."""
    args = exact_case[0]
    table, tiles, rng = bp.exact_glue(*(torch.as_tensor(a) for a in args))
    pairs, rows = bp.tile_schedule(table, tiles, rng)
    n = len(args[0])
    rank = np.empty(n, np.int64)
    rank[table[:n, 11].long().numpy()] = np.arange(n)
    i, j = _overlaps(args)
    NT = tiles.shape[0]
    at = np.full((NT, NT), -1)
    at[pairs[:, 0].numpy(), pairs[:, 1].numpy()] = np.arange(len(pairs))
    p = at[rank[i] // bp.TILE, rank[j] // bp.TILE]
    assert (p >= 0).all()
    assert rows.numpy()[p, rank[j] % bp.TILE].all()
    # The cull is finer than the JAX kernel's 128 x 128 chunk walk.
    assert int(rows.sum()) * bp.TILE <= int((rng[:, 1] - rng[:, 0]).clamp(min=0).sum()) * 128 * 128


def _tile_keys(q, cand, bits, qs, qmax):
    """Keys of query rows q (32, ROW) against candidate rows (C, ROW) of the
    sorted table, IMAX where the pair makes none (the kernel's row test)."""
    over = torch.all((cand[None, :, 4:7] <= q[:, None, 8:11])
                     & (q[:, None, 4:7] <= cand[None, :, 8:11]), -1)
    ok = (over & (q[:, None, 7] > 0.5) & (cand[None, :, 7] > 0.5)
          & (q[:, None, 3] != cand[None, :, 3]) & (q[:, None, 11] != cand[None, :, 11]))
    da = cand[None, :, :3] - q[:, None, :3]
    d2 = (da[..., 0] * da[..., 0] + da[..., 1] * da[..., 1]) + da[..., 2] * da[..., 2]
    qv = torch.clamp(d2 * qs, max=qmax).to(torch.int32)
    return torch.where(ok, (qv << bits) | cand[None, :, 11].to(torch.int32), bp.IMAX)


def _k_smallest(keys, K):
    pad = torch.full((keys.shape[0], K), bp.IMAX, dtype=torch.int32)
    return torch.topk(torch.cat([keys, pad], 1), K, 1, largest=False, sorted=True).values


def _dense_boxes(n=500, seed=31):
    """Boxes packed so densely that most pieces overlap more than 32 others
    (3 pieces an owner, 5% invalid): K = 32 and 64 truncate."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    half = rng.uniform(0.4, 0.9, (n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.05
    return c, c - half, c + half, (np.arange(n) // 3).astype(np.int32), valid


def _schedule_kbest(args, K, groups=4):
    """The tiled sweep's walk emulated (``tile_schedule``, warp g of a query
    tile taking the visited row tiles g, g + groups, ..., each warp's K
    smallest keys merged): the K best keys in piece order."""
    table, tiles, rng = bp.exact_glue(*(torch.as_tensor(a) for a in args))
    pairs, rows = bp.tile_schedule(table, tiles, rng)
    n = len(args[0])
    bits, qmax, qs = bp._quant(n)
    NT = tiles.shape[0]
    T = table.reshape(NT, bp.TILE, bp.ROW)
    best = torch.empty((NT * bp.TILE, K), dtype=torch.int32)
    for tq in range(NT):
        sel = pairs[:, 0] == tq
        mine, ok = pairs[sel, 1], rows[sel]
        lists = [_k_smallest(_tile_keys(T[tq], T[mine[g::groups]][ok[g::groups]], bits, qs, qmax),
                             K) for g in range(groups)]
        best[tq * bp.TILE:(tq + 1) * bp.TILE] = _k_smallest(torch.cat(lists, 1), K)
    merged = torch.empty((n, K), dtype=torch.int32)
    merged[table[:n, 11].long()] = best[:n]
    return merged.numpy(), bits


@pytest.mark.parametrize("groups", [1, 4])
def test_group_kbest_merge_equals_one_pass(exact_case, groups):
    """The kernel's split, emulated: per query tile, warp g takes the
    visited row tiles g, g + groups, ..., keeps the K smallest keys of its
    rows, and the lists merge; slot for slot the one-pass K best."""
    args, K, got, _, _ = exact_case
    merged, bits = _schedule_kbest(args, K, groups)
    mask = (1 << bits) - 1
    one_pass = (got[2] & ~mask) | got[0]           # the keys from (key_ji, pidx)
    np.testing.assert_array_equal(merged, one_pass)


@pytest.mark.parametrize("K", [32, 64])
def test_long_list_schedule_equals_plain_and_pallas(K):
    """B6 past K = 16 (the long variant: the tiled sweep with lists of 32 or
    64 keys): its walk and merge give the plain version's K best slot for
    slot on boxes where most lists truncate; at K = 32 the plain version
    equals the JAX kernel (interpret mode) in every output."""
    args = _dense_boxes()
    assert bp._exact_variant(K) == "long"
    got = bp.broadphase_exact(*(torch.as_tensor(a) for a in args), K)
    pidx, pok, key_ji, theta = (t.numpy() for t in (got[0], got[1], *got[2]))
    assert 0.5 < (pok.sum(1) == K).mean() < 1.0               # most lists full, some not
    keys, bits = _schedule_kbest(args, K)
    mask = (1 << bits) - 1
    np.testing.assert_array_equal(keys, (key_ji & ~mask) | pidx)
    np.testing.assert_array_equal(keys[:, -1], theta)
    if K == 32:
        want, _ = _jax_exact(args, K)
        for name, g, w in zip(("pidx", "pok", "key_ji", "theta"), (pidx, pok, key_ji, theta),
                              want):
            np.testing.assert_array_equal(g, w, err_msg=name)


def _pairs(pidx, pok):
    return {(i, int(pidx[i, k])) for i, k in zip(*np.nonzero(pok))}


@pytest.mark.parametrize("case", ["random700", "shared_owners"])
def test_exact_theta_mutual_equals_block_sweep_mutual(case):
    args = EXACT_CASES[case]
    K = 8
    pidx, pok, mut = bp.broadphase_exact(*(torch.as_tensor(a) for a in args), K)
    got = _pairs(pidx.numpy(), bp.apply_theta_mutual(pidx, pok, mut).numpy())
    jp, jok = j_block_sweep(*(jnp.asarray(a) for a in args), K, 256)
    me = jnp.arange(jp.shape[0])[:, None, None]
    jok = jok & jnp.any(jp[jp] == me, axis=-1)
    assert got == _pairs(np.asarray(jp), np.asarray(jok))
    assert all((j, i) in got for i, j in got)


def test_morton_codes_equal():
    c, _, _, _, valid = _random_boxes(500, seed=13, invalid=0.1)
    c[:20] = c[20:40]                              # equal centers, equal codes
    got = morton(torch.as_tensor(c), torch.as_tensor(valid)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_morton(jnp.asarray(c), jnp.asarray(valid))))


def _sorted_case(kind):
    # The three cases of tests/test_broadphase_pallas.py, half extent 0.6.
    if kind == "random":
        rng = np.random.default_rng(3)
        n = 257
        c = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
        owner, valid = np.arange(n), np.ones(n, bool)
    elif kind == "lattice_ties":
        g = np.arange(6, dtype=np.float32) * 1.02
        c = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
        n = len(c)
        owner, valid = np.arange(n), np.ones(n, bool)
    else:
        rng = np.random.default_rng(11)
        n = 140
        c = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
        owner = np.arange(n) // 2
        valid = rng.uniform(size=n) > 0.2
    h = np.full_like(c, 0.6)
    return c, c - h, c + h, owner.astype(np.int32), valid


SORTED_KINDS = ["random", "lattice_ties", "invalid_shared_owner"]
# (K, W): the first cases' 4 and 8, the physics configuration's 8 and 32, and
# K = 2W; on the tie-heavy lattice, shapes of the list selection: K past 16,
# W past 128, K past one slot a lane. The JAX side runs at the first and
# last of these only: its XLA original takes 5 s at W = 256, past this
# file's budget, so there the plain version and its mirrors stand alone.
LIST_SHAPES = ((32, 32), (48, 32))
SORTED_PARAMS = ([pytest.param(kind, 4, 8, id=kind) for kind in SORTED_KINDS]
                 + [pytest.param(kind, K, W, id=f"{kind}-K{K}-W{W}")
                    for K, W in ((8, 32), (16, 8)) for kind in SORTED_KINDS]
                 + [pytest.param("lattice_ties", K, W, id=f"lattice_ties-K{K}-W{W}")
                    for K, W in LIST_SHAPES])
MIRROR_PARAMS = SORTED_PARAMS + [pytest.param("lattice_ties", 8, 256, id="lattice_ties-K8-W256")]


def _jax_sorted(args, K, W):
    """The JAX package's B12 result: ``broadphase_sorted_pallas`` in
    interpret mode; at the list selection's shapes its XLA original
    (``_broadphase_sorted`` and the mutual mask, jitted), which
    tests/test_broadphase_pallas.py holds the Pallas kernel to: interpret
    mode takes 9 s at K = 32, W = 32."""
    a = [jnp.asarray(x) for x in args]
    if (K, W) not in LIST_SHAPES:
        return jbp.broadphase_sorted_pallas(*a, K, W, interpret=True)

    def xla(centers, lo, hi, owner, valid):
        pidx, pok, *_ = j_window_sweep(centers, lo, hi, owner, valid, K, W)
        me = jnp.arange(centers.shape[0], dtype=jnp.int32)[:, None, None]
        return pidx, pok & jnp.any(pidx[pidx] == me, axis=-1)
    return jax.jit(xla)(*a)


@pytest.mark.parametrize("kind,K,W", SORTED_PARAMS)
def test_sorted_matches_pallas_live_slots(kind, K, W):
    args = _sorted_case(kind)
    jp, jok = (np.asarray(x) for x in _jax_sorted(args, K, W))
    before = bp.sorted_launches
    tp, tok = bp.broadphase_sorted(*(torch.as_tensor(a) for a in args), K, W)
    assert bp.sorted_launches == before
    tp, tok = tp.numpy(), tok.numpy()
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(np.where(tok, tp, -1), np.where(jok, jp, -1))
    assert tok.any()


def _jax_sorted_operands(args, K, W):
    """The (11, Np_pad) sorted pack and (1, Np_pad) order that the JAX
    wrapper hands its kernel."""
    seen = {}
    real = jbp.pl.pallas_call

    def recording(kernel, **kw):
        call = real(kernel, **kw)

        def run(*ops):
            seen["ops"] = [np.asarray(o) for o in ops]
            return call(*ops)
        return run

    jbp.pl.pallas_call = recording
    try:
        jbp.broadphase_sorted_pallas(*(jnp.asarray(a) for a in args), K, W, interpret=True)
    finally:
        jbp.pl.pallas_call = real
    return seen["ops"]


@pytest.mark.parametrize("kind", SORTED_KINDS)
def test_sorted_glue_mirror_matches_the_jax_wrapper(kind):
    # B12's glue mirror: the codes of morton() (the JAX package's _morton),
    # the JAX wrapper's argsort and its sorted pack, column for column.
    args = _sorted_case(kind)
    t = [torch.as_tensor(a) for a in args]
    codes, order, table = bp.sorted_glue(*t)
    np.testing.assert_array_equal(codes.numpy(), morton(t[0], t[4]).numpy())
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(j_morton(jnp.asarray(args[0]), jnp.asarray(args[4]))))
    packT, origT = _jax_sorted_operands(args, 4, 8)
    Np = t[0].shape[0]
    np.testing.assert_array_equal(order.numpy(), origT[0, :Np])
    tab = table.numpy()
    for cols, rows in (((0, 1, 2), (0, 1, 2)), ((3,), (9,)), ((4, 5, 6), (3, 4, 5)), ((7,), (10,)),
                       ((8, 9, 10), (6, 7, 8))):
        np.testing.assert_array_equal(tab[:, list(cols)], packT[list(rows), :Np].T)
    np.testing.assert_array_equal(tab[:, 11].view(np.int32), origT[0, :Np])


@pytest.mark.parametrize("kind,K,W", MIRROR_PARAMS)
def test_selection_mirror_reproduces_the_window_sweep(kind, K, W):
    # B12's selection and mutual mirrors on the mirror's table give
    # morton_window_sweep's picks (every slot, filler included) and the
    # plain version's mutual mask; each lane's mask holds its K picks; the
    # list selection's rounds give the same picks in the same order.
    t = [torch.as_tensor(a) for a in _sorted_case(kind)]
    _, _, table = bp.sorted_glue(*t)
    picks, real, sel = bp.window_selection(table, K, W)
    lp, lreal = _list_rounds(table, K, W)
    np.testing.assert_array_equal(lp, picks.numpy())
    np.testing.assert_array_equal(lreal, real.numpy())
    assert torch.equal(sel.sum(1), torch.full((table.shape[0],), K))
    assert torch.equal(torch.gather(sel, 1, picks), torch.ones_like(real))
    pidx, pok = bp.window_mutual(table, picks, real, sel, W)
    sp, sok = morton_window_sweep(*t, K, W)
    rp, rok = bp.broadphase_sorted_reference(*t, K, W)
    assert torch.equal(pidx, sp) and torch.equal(pidx, rp)
    assert torch.equal(pok, rok) and bool((sok | ~pok).all())
    assert bool(pok.any())


def _list_rounds(table, K, W):
    """The list selection's rounds in numpy: warp lane t of a sorted lane
    holds the candidates t, t + 32, ... scored as ``window_selection``
    scores them, ordered by (score descending, candidate ascending) and cut
    to min(K, ceil(2W / 32)) entries; each round takes the largest head
    score, the lowest candidate among the lanes holding it, and advances
    that lane's head. Returns the picks (Np, K) and their real flags."""
    Np = table.shape[0]
    per = -(-2 * W // 32)
    rank = np.arange(Np)[:, None] + np.asarray(bp.window_deltas(W))[None]
    tab = table.numpy()
    cand, me = tab[np.clip(rank, 0, Np - 1)], tab[:, None]
    ok = (np.all((me[..., 4:7] <= cand[..., 8:11]) & (cand[..., 4:7] <= me[..., 8:11]), -1)
          & (rank >= 0) & (rank < Np) & (cand[..., 7] > 0.5) & (me[..., 7] > 0.5)
          & (cand[..., 3] != me[..., 3]))
    d = me[..., 0:3] - cand[..., 0:3]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    score = np.full((Np, 32 * per), -np.inf, np.float32)     # past 2W: no candidate
    score[:, :2 * W] = np.where(ok, -d2, np.float32(-bp.BIG))
    lanes = score.reshape(Np, per, 32).transpose(0, 2, 1)     # [lane r, warp lane t, j]
    order = np.argsort(-lanes, axis=2, kind="stable")[..., :min(K, per)]
    lists = np.take_along_axis(lanes, order, 2)
    heads = np.zeros((Np, 32), np.int64)
    picks = np.empty((Np, K), np.int64)
    rows = np.arange(Np)
    for k in range(K):
        live = heads < lists.shape[2]
        hs = np.where(live, np.take_along_axis(lists, np.minimum(heads, lists.shape[2] - 1)[..., None],
                                               2)[..., 0], -np.inf)
        hc = np.arange(32)[None] + 32 * np.take_along_axis(
            order, np.minimum(heads, lists.shape[2] - 1)[..., None], 2)[..., 0]
        best = hs.max(1, keepdims=True)
        win = np.where(hs == best, hc, np.iinfo(np.int64).max).min(1)
        picks[:, k] = win
        heads[rows, win % 32] += 1
    real = np.take_along_axis(score, picks, 1) > -bp.BIG / 2
    return picks, real


def test_sorted_k_beyond_two_windows_raises():
    args = [torch.as_tensor(a) for a in _sorted_case("random")]
    with pytest.raises(ValueError, match="2·window"):
        bp.broadphase_sorted(*args, 5, 2)


def _lattice_scene(cfg, n=27):
    return build_scene(workload.cube_pieces(workload.lattice_offsets(n)), cfg, max_bodies=n)


def _route(monkeypatch, cfg, n=27):
    """Which broadphase ``physics_step`` called: "exact", "exact_pallas"
    or "sorted"."""
    called = []
    for attr, name in (("block_sweep", "exact"), ("broadphase_exact", "exact_pallas"),
                       ("broadphase_sorted", "sorted")):
        fn = getattr(tstep, attr)

        def rec(*a, _fn=fn, _name=name, **kw):
            called.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(tstep, attr, rec)
    tstep.physics_step(_lattice_scene(cfg, n), cfg)
    return called


@pytest.mark.parametrize("block,max_np,route,warns", [
    (64, 64, "exact", False),            # Np ≤ broadphase_block
    (16, 64, "exact_pallas", False),     # block < Np ≤ MAX_EXACT_NP
    (16, 20, "sorted", True),            # Np > MAX_EXACT_NP
])
def test_auto_dispatch(monkeypatch, block, max_np, route, warns):
    monkeypatch.setattr(tstep, "MAX_EXACT_NP", max_np)
    cfg = dataclasses.replace(workload.PHYSICS_CFG, broadphase_block=block)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert _route(monkeypatch, cfg) == [route]
    got = [x for x in w if issubclass(x.category, tstep.RecallDegradedWarning)]
    assert bool(got) == warns
