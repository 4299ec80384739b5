"""Kernel B7's plain version (``narrowphase_cuda.narrowphase_reference``, the
CPU side of ``csrc/narrowphase.cu``) against the JAX package's
``narrowphase_raw_pallas`` in interpret mode, on the same packed table,
partner indices and candidate flags; and the port's exact broadphase
against the JAX package's ``_broadphase`` with its mutual mask.

Four scenes: strongly rotated overlapping boxes, whose SAT minima are
unique; an axis-aligned lattice of cubes pressed 0.002 into each other,
where DOP and face axes tie exactly and the first-of-ties order decides the
normal; the rotated boxes with a dead last piece that every empty slot
names, as the sweep-and-prune B6 leaves its empty slots (the id sentinel,
clamped to the last piece): against a piece with no live corner an edge
axis has no finite penetration, and the pair's depth is NaN and its normal
0; and a frame-shaped scene at the interactive frame's hull size
(``max_hull_verts=64``, F = 32): 24 Voronoi cells of the unit cube, two to
a compound body, the bodies turned a little so that neighbouring cells
overlap. Tolerances: hit flags and feature ids exactly; normals, depths,
manifold values and points within 1e-5 absolute on these unit-scale scenes
(they agree bit for bit with the JAX run below; the bound leaves room for
another XLA version's rounding); the broadphase exactly (indices and flags,
filler slots included).

The JAX side runs compiled in a child process with
``--xla_cpu_max_isa=AVX`` (ROADMAP C5): on an AVX2/AVX-512 host XLA:CPU
contracts the kernel's products into FMAs, and on rotated boxes that moves
first-of-ties picks between corners whose depths agree to the last bits (a
contacting edge's two ends, a resting face's corners). Without FMA both
sides round every product, and the outputs agree bit for bit. Run as a
script (``python tests/test_torch_narrowphase.py OUT.npz``) it writes the
JAX side of both scenes.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surtr_tpu.config import PhysicsConfig as JPhysicsConfig
from surtr_tpu.fracture.types import PieceSet as JPieceSet
from surtr_tpu.ops.voronoi import voronoi_cells
from surtr_tpu.physics.narrowphase_pallas import narrowphase_raw_pallas
from surtr_tpu.physics.pack_pallas import transform_pack_pallas
from surtr_tpu.physics.rigid import quat_normalize as j_quat_normalize
from surtr_tpu.physics.scene import build_scene as j_build_scene
from surtr_tpu.physics.step import _broadphase as j_broadphase
from surtr_tpu_torch.physics import narrowphase_cuda
from surtr_tpu_torch.physics.broadphase import block_sweep, mutual

from test_torch_pack import j_cube_pieces
from torch_threads import bounded_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ("rotated", "lattice", "dead_partner", "frame")
CFG = JPhysicsConfig(single_piece_bodies=True, max_hull_verts=8)
# The interactive frame's physics: compound bodies, hulls of up to 64 corners.
FRAME_CFG = JPhysicsConfig(max_hull_verts=64)
K, M, G = CFG.max_neighbors, CFG.manifold_points, CFG.max_ground_contacts
assert (FRAME_CFG.max_neighbors, FRAME_CFG.manifold_points) == (K, M)


def _frame_scene():
    """24 Voronoi cells of the unit cube (F = 32), two a body, each body
    turned a little."""
    rng = np.random.default_rng(33)
    n = 24
    cells = voronoi_cells(jnp.asarray(rng.uniform(-0.5, 0.5, (n, 3)), jnp.float32),
                          k=n - 1, F=32, S=16)
    pieces = JPieceSet(convex=cells, mesh=jnp.zeros((n, 1, 3, 3)),
                       mesh_valid=jnp.zeros((n, 1), bool), valid=jnp.ones(n, bool),
                       group=jnp.arange(n, dtype=jnp.int32) // 2,
                       tag=jnp.full((n,), -1, jnp.int32))
    sc = j_build_scene(pieces, FRAME_CFG, max_bodies=n // 2)
    q = np.asarray(sc.bodies.q)
    q = np.asarray(j_quat_normalize(jnp.asarray(q + 0.05 * rng.standard_normal(q.shape),
                                                jnp.float32)))
    return sc, q


def _scene(kind):
    if kind == "frame":
        return _frame_scene()
    rng = np.random.default_rng(31)
    if kind != "lattice":
        offs = np.concatenate([rng.uniform(-0.7, 0.7, (10, 3)) + [0.0, -0.8, 0.0],
                               [[5.0, -1.45, 0.0], [9.0, 0.0, 0.0]]]).astype(np.float32)
    else:
        xs = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"), -1).reshape(-1, 3)
        offs = (xs * 0.998 + np.array([-1.5, -1.45, -1.5])).astype(np.float32)
    n = len(offs)
    pieces = j_cube_pieces(offs)
    if kind == "dead_partner":
        pieces = dataclasses.replace(pieces, valid=pieces.valid.at[-1].set(False))
    sc = j_build_scene(pieces, CFG, max_bodies=n)
    q = np.asarray(sc.bodies.q)
    if kind != "lattice":
        q = np.asarray(j_quat_normalize(jnp.asarray(q + 0.6 * rng.standard_normal(q.shape), jnp.float32)))
    return sc, q


def _jax_side(kind):
    """Pack (JAX interpret), the JAX broadphase + mutual mask and the JAX
    narrowphase, as numpy arrays."""
    sc, q = _scene(kind)
    Vh, F, Ne = sc.piece_verts.shape[1], sc.piece_planes.shape[1], sc.piece_edges.shape[1]
    pvalid = sc.piece_valid & (sc.piece_owner >= 0)
    pose = (jnp.asarray(q), sc.bodies.x)
    if kind == "frame":                       # compound bodies: each piece's owner's pose
        own = jnp.clip(sc.piece_owner, 0)
        pose = (pose[0][own], pose[1][own])
    pT, ab = transform_pack_pallas(
        sc.piece_verts, sc.piece_vmask, sc.piece_planes, sc.piece_pmask, sc.piece_edges,
        sc.piece_emask, *pose, pvalid, Vh=Vh, F=F, Ne=Ne,
        margin=CFG.contact_slop * 4.0, interpret=True)
    abT = ab.T
    jp, jok = j_broadphase(abT[:, 6:9], abT[:, 0:3], abT[:, 3:6], sc.piece_owner, pvalid, K,
                           CFG.broadphase_block)
    me = jnp.arange(jp.shape[0])[:, None, None]
    jok = jok & jnp.any(jp[jp] == me, axis=-1)
    # The narrowphase's candidates: the broadphase's, or B6's empty-slot
    # sentinel in every slot that is not a mutual pair.
    np_pidx = jnp.where(jok, jp, (1 << 14) - 1) if kind == "dead_partner" else jp
    out, Np_pad = narrowphase_raw_pallas(None, np_pidx, jok, Vh=Vh, F=F, Ne=Ne, K=K, M=M,
                                         slop=CFG.contact_slop, interpret=True, packedT=pT)
    Np = jp.shape[0]
    R = 5 + 6 * M
    want = np.asarray(out).reshape(-1, K, Np_pad)[:R, :, :Np].transpose(2, 1, 0)
    return dict(packed=np.asarray(pT).T, aabb=np.asarray(abT), owner=np.asarray(sc.piece_owner),
                pvalid=np.asarray(pvalid), jp=np.asarray(jp), jok=np.asarray(jok),
                np_pidx=np.asarray(np_pidx), want=want,
                dims=np.array([Vh, F, Ne]))


def _port_side(ref):
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    ab = ref["aabb"]
    tp, tok = block_sweep(t(ab[:, 6:9]), t(ab[:, 0:3]), t(ab[:, 3:6]), t(ref["owner"]),
                          t(ref["pvalid"]), K, CFG.broadphase_block)
    tok = mutual(tp, tok)
    Vh, F, Ne = (int(v) for v in ref["dims"])
    before = narrowphase_cuda.launches
    got = narrowphase_cuda.narrowphase(t(ref["packed"]), t(ref["np_pidx"]), t(ref["jok"]), Vh, F, Ne,
                                       M, CFG.contact_slop)
    assert narrowphase_cuda.launches == before      # CPU tensors: no launch
    return dict(ref, tp=tp.numpy(), tok=tok.numpy(), got=got.numpy(), Vh=Vh)


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    out = tmp_path_factory.mktemp("narrowphase") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    data = np.load(out)
    return {kind: {k.split("/", 1)[1]: data[k] for k in data.files if k.startswith(kind + "/")}
            for kind in SCENES}


@pytest.fixture(scope="module", params=SCENES)
def run(request, jax_refs):
    return _port_side(jax_refs[request.param])


def test_broadphase_matches(run):
    np.testing.assert_array_equal(run["tp"], run["jp"])
    np.testing.assert_array_equal(run["tok"], run["jok"])


def test_flags_and_feature_ids_exact(run):
    got, want = run["got"], run["want"]
    assert got[..., 4].sum() > 0, "no pair hit: the comparison proves nothing"
    exact = [4] + [6 + 6 * m for m in range(M)] + [10 + 6 * m for m in range(M)]
    np.testing.assert_array_equal(got[..., exact], want[..., exact])


def test_normals_depths_points_close(run):
    got, want = run["got"], run["want"]
    big = np.abs(want) > 1e30
    np.testing.assert_array_equal(got[big], want[big])
    np.testing.assert_allclose(np.where(big, 0, got), np.where(big, 0, want), atol=1e-5, rtol=0)


def test_dead_partner_has_no_depth(jax_refs):
    """Slots naming the dead piece: depth NaN and normal 0 on both sides,
    never a hit, and every manifold point finite."""
    r = _port_side(jax_refs["dead_partner"])
    got, want = r["got"], r["want"]
    dead = r["np_pidx"] == len(r["pvalid"]) - 1
    dead |= r["np_pidx"] >= len(r["pvalid"])
    assert dead.any() and not r["pvalid"][-1]
    assert np.isnan(got[..., 3][dead]).all() and np.isnan(want[..., 3][dead]).all()
    np.testing.assert_array_equal(got[..., 0:3][dead], 0.0)
    assert not got[..., 4][dead].any()
    pts = [7 + 6 * m + c for m in range(M) for c in range(3)]
    assert np.isfinite(got[..., pts]).all()


def test_rotated_scene_reaches_the_fallback(jax_refs):
    """Edge-on contacts between rotated boxes contain no corner of either
    hull; their single point comes from the support fallback (fid > 2Vh)."""
    r = _port_side(jax_refs["rotated"])
    fb = (r["got"][..., 10] > 2 * r["Vh"]) & (r["got"][..., 6] > 0.5)
    assert fb.any()
    np.testing.assert_array_equal(fb, (r["want"][..., 10] > 2 * r["Vh"]) & (r["want"][..., 6] > 0.5))


def test_broadphase_fewer_pieces_than_k():
    """Np < K: every list is padded past the pool with index 0, pok false."""
    rng = np.random.default_rng(32)
    c = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    lo, hi = c - 0.8, c + 0.8
    owner = np.arange(5, dtype=np.int32)
    valid = np.array([1, 1, 1, 0, 1], bool)
    jp, jok = j_broadphase(jnp.asarray(c), jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(owner),
                           jnp.asarray(valid), K, 64)
    tp, tok = block_sweep(*(torch.as_tensor(a) for a in (c, lo, hi, owner, valid)), K, 64)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


if __name__ == "__main__":
    np.savez(sys.argv[1], **{f"{kind}/{k}": v for kind in SCENES
                             for k, v in _jax_side(kind).items()})


# ---------------------------------------------------------------------------
# The group variant's pick rounds (csrc/narrowphase.cu ``narrow_group_kernel``)
# mirrored in numpy against the plain version's picks.
# ---------------------------------------------------------------------------

BIG32 = np.float32(narrowphase_cuda.BIG)


def _lattice_call(Vh, rotate=True):
    """The narrowphase arguments of one step of the port's 27-cube lattice
    at ``max_hull_verts=Vh`` on the CPU (8 live corners a cube, the rest
    masked); ``rotate`` turns each body a little first (seeded), so corners
    poke into their neighbours."""
    from surtr_tpu_torch import workload
    from surtr_tpu_torch.physics import step as phys_step

    cfg = dataclasses.replace(workload.PHYSICS_CFG, max_hull_verts=Vh)
    scene = workload.physics_lattice(27, "cpu", cfg)
    if rotate:
        q = scene.bodies.q
        g = torch.Generator().manual_seed(21)
        q = q + 0.15 * torch.randn(q.shape, generator=g)
        scene = dataclasses.replace(scene, bodies=dataclasses.replace(
            scene.bodies, q=q / q.norm(dim=-1, keepdim=True)))
    calls = []
    orig = phys_step.narrowphase

    def rec(*a):
        calls.append(a)
        return orig(*a)

    phys_step.narrowphase = rec
    try:
        phys_step.physics_step(scene, cfg)
    finally:
        phys_step.narrowphase = orig
    return calls[0]


def _mirror_scores(packed, pidx, n, Vh, F, Ne, slop):
    """The 2Vh candidate scores of each pair, each scored once, as the group
    kernel scores them (float32, the plain version's operation order): i's
    corners contained in j, then j's contained in i, -BIG elsewhere."""
    from surtr_tpu_torch.physics.pack_cuda import pack_layout

    offs, _ = pack_layout(Vh, F, Ne)
    Np = packed.shape[0]
    take = lambda rows, name: rows[..., offs[name][0]:offs[name][0] + offs[name][1]]  # noqa: E731
    pi = packed[:, None, :]
    pj = packed[np.clip(pidx, 0, Np - 1)]
    f32 = np.float32
    slop = f32(slop)
    with np.errstate(invalid="ignore", over="ignore"):
        def corners(rows):
            return [take(rows, k)[..., :, None] for k in ("wvx", "wvy", "wvz")], take(rows, "wm") > 0.5

        def inside(cs, rows):      # each corner's max distance over the live planes <= slop
            pn = [take(rows, k)[..., None, :] for k in ("pnx", "pny", "pnz")]
            d = ((cs[0] * pn[0] + cs[1] * pn[1]) + cs[2] * pn[2]) + take(rows, "pd")[..., None, :]
            live = (take(rows, "pm") > 0.5)[..., None, :]
            return np.max(np.where(live, d, -BIG32), axis=-1) <= slop

        ic, im = corners(pi)
        jc, jm = corners(pj)
        nn = [n[..., c, None] for c in range(3)]
        si = (ic[0][..., 0] * nn[0] + ic[1][..., 0] * nn[1]) + ic[2][..., 0] * nn[2]
        sj = (jc[0][..., 0] * nn[0] + jc[1][..., 0] * nn[1]) + jc[2][..., 0] * nn[2]
        si_min = np.min(np.where(im, si, BIG32), axis=-1, keepdims=True)
        sj_max = np.max(np.where(jm, sj, -BIG32), axis=-1, keepdims=True)
        sc_i = np.where(inside(ic, pj) & im, sj_max - si, -BIG32)
        sc_j = np.where(inside(jc, pi) & jm, sj - si_min, -BIG32)
    return np.concatenate([sc_i, sc_j], axis=-1).astype(f32)


def _mirror_picks(sc, M):
    """The group kernel's M pick rounds on scores ``sc`` (..., 2Vh): a taken
    mask; each round the arg-max on (score, candidate) as the group
    reduction takes it (torch.argmax's rule: the first NaN if any, else the
    first of the maxima; a taken candidate counts -BIG). Returns the picks
    (..., M) and their values."""
    taken = np.zeros(sc.shape, bool)
    picks, vals = [], []
    idx = np.arange(sc.shape[-1])
    for _ in range(M):
        s = np.where(taken, -BIG32, sc)
        nan = np.isnan(s)
        first_nan = np.where(nan, idx, sc.shape[-1]).min(-1)
        mx = np.max(np.where(nan, -np.inf, s), axis=-1, keepdims=True)
        first_max = np.where(s == mx, idx, sc.shape[-1]).min(-1)
        b = np.where(nan.any(-1), first_nan, first_max)
        picks.append(b)
        vals.append(np.take_along_axis(s, b[..., None], -1)[..., 0])
        taken |= idx == b[..., None]
    return np.stack(picks, -1), np.stack(vals, -1)


def _check_mirror(packed, pidx, pok, Vh, F, Ne, M, slop):
    """The mirror's picks and values against ``narrowphase_reference``'s
    feature ids and values, every round (the first only where it is not the
    fallback's point); returns the number of pairs whose rounds held a NaN."""
    out = narrowphase_cuda.narrowphase_reference(packed, pidx, pok, Vh, F, Ne, M, slop).numpy()
    sc = _mirror_scores(packed.numpy(), pidx.numpy(), out[..., 0:3], Vh, F, Ne, slop)
    picks, vals = _mirror_picks(sc, M)
    hit = out[..., 4] > 0.5
    with np.errstate(invalid="ignore"):
        h = hit[..., None] & (vals > -np.float32(slop)) & (vals < BIG32 / 2)
    fallback = hit & ~h.any(-1)
    for m in range(M):
        keep = ~fallback if m == 0 else np.ones_like(hit)
        fid = out[..., 5 + 6 * m + 5]
        np.testing.assert_array_equal(fid[keep], (picks[..., m] + 1)[keep].astype(np.float32))
        got, want = vals[..., m][keep], out[..., 5 + 6 * m][keep]
        same = (got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))
        assert same.all(), m
    return int(np.isnan(sc).any(-1).sum())


def test_group_pick_rounds_mirror_the_plain_picks():
    """Vh 12 with M 4, and M 30 > 2Vh (every candidate taken, then the
    first -BIG again), on the rotated lattice; pieces whose corners are all
    masked (and, every tenth, their edges too: a NaN axis, normal 0); a NaN
    candidate 0 and NaN candidates past it (a live NaN corner of the
    partner makes sj_max NaN for every contained corner of the piece, whose
    contained corner is moved to slot 0): the plain version takes the first
    NaN, then the next."""
    from surtr_tpu_torch.physics.pack_cuda import pack_layout

    packed, pidx, pok, Vh, F, Ne, M, slop = _lattice_call(12)
    assert (Vh, M) == (12, 4) and narrowphase_cuda._variant(Vh, pidx.shape[1], F, Ne, M) == "group"
    assert _check_mirror(packed, pidx, pok, Vh, F, Ne, 4, slop) == 0
    assert _check_mirror(packed, pidx, pok, Vh, F, Ne, 30, slop) == 0
    offs, _ = pack_layout(Vh, F, Ne)
    masked = packed.clone()
    wo, wc = offs["wm"]
    eo, ec = offs["em"]
    masked[1::5, wo:wo + wc] = 0.0
    masked[::10, eo:eo + ec] = 0.0
    _check_mirror(masked, pidx, pok, Vh, F, Ne, 4, slop)
    # A pair with a contained corner of i: that corner moved to slot 0, a
    # live NaN corner put in j's first masked slot.
    out = narrowphase_cuda.narrowphase_reference(packed, pidx, pok, Vh, F, Ne, M, slop).numpy()
    sc = _mirror_scores(packed.numpy(), pidx.numpy(), out[..., 0:3], Vh, F, Ne, slop)
    contained = sc[..., :Vh] > -BIG32
    i, k = np.argwhere(contained.sum(-1) >= 2)[0]
    c = int(np.argmax(contained[i, k]))
    j = int(pidx[i, k])
    nan = packed.clone()
    for name in ("wvx", "wvy", "wvz", "wm"):
        o = offs[name][0]
        nan[i, o], nan[i, o + c] = packed[i, o + c], packed[i, o]
    slot = int(np.argmin(packed[j, wo:wo + wc].numpy() > 0.5))
    nan[j, offs["wvx"][0] + slot] = float("nan")
    nan[j, wo + slot] = 1.0
    sc = _mirror_scores(nan.numpy(), pidx.numpy(), narrowphase_cuda.narrowphase_reference(
        nan, pidx, pok, Vh, F, Ne, M, slop).numpy()[..., 0:3], Vh, F, Ne, slop)
    assert np.isnan(sc[i, k, 0]) and np.isnan(sc[i, k, 1:Vh]).any()
    assert _check_mirror(nan, pidx, pok, Vh, F, Ne, 4, slop) > 0
