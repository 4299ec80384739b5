"""Kernels B8 and B9's plain versions (``prep_cuda.prep_contacts_reference``
and ``solver_cuda.solve`` on CPU tensors, the CPU sides of ``csrc/prep.cu``
and ``csrc/solver.cu``) against the JAX package's ``prep_contacts_pallas``
and ``solve_packed`` in interpret mode, on the same random contact tables:
hit and missed slots, static and sleeping partners, zero and positive
inverse masses, and a wake seed. The accumulated (warm-start) mode of B9,
``solver_cuda.solve_warm``, against ``solve_packed(..., lam0=...)``, and
``prep_cuda.warm_preapply`` followed by it against ``prep_and_solve`` with
matched warm impulses. B8's entry ``prep_from_records`` (the slot assembly
and partner gather inside): bitwise equal to the step's former PyTorch glue
followed by ``prep_contacts_reference`` on random pair records (NaN depths
of dead partners, pidx = -1 slots, sleeping and static partners, rows with
no hit), and against the JAX package's own step glue (``_fused_prep_solve``
stopped after its prep) with ``prep_contacts_pallas`` at the tolerances
below, NaN against NaN.

Tolerances: hit and static flags and the wake flag exactly (0/1 values);
every prep table within 1e-5 × max(1, |value|) per entry (XLA may contract
products into FMAs where the port rounds each one; m_eff = 1/k is large
where k is small); v and w after 1 and 4 outer iterations within 1e-5 ×
(1 + |v|), and the accumulated impulses within 1e-5 × (1 + the slot's
largest |λ|) (the cone clamp ties the friction pair to λn), since the
JAX kernel's per-row sums over the C slots are taken in an order XLA
chooses, the port's in slot order.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import surtr_tpu.physics.prep_pallas as j_prep
from surtr_tpu.config import PhysicsConfig as JPhysicsConfig
from surtr_tpu.physics import step as j_step
from surtr_tpu.physics.prep_pallas import prep_and_solve, prep_contacts_pallas
from surtr_tpu.physics.rigid import quat_normalize as j_quat_normalize
from surtr_tpu.physics.scene import build_scene as j_build_scene
from surtr_tpu.physics.solver_pallas import solve_packed
from surtr_tpu.physics.solver_pallas import tangent_basis as j_tangent_basis
from surtr_tpu_torch import workload
from surtr_tpu_torch.physics import prep_cuda, solver_cuda
from surtr_tpu_torch.physics import step as t_step
from surtr_tpu_torch.physics.rigid import world_inv_inertia
from tests.test_torch_pack import j_cube_pieces
from torch_threads import bounded_threads  # noqa: F401 (autouse)

CFG = JPhysicsConfig()
K, M, G = CFG.max_neighbors, CFG.manifold_points, CFG.max_ground_contacts
C = K * M + G
NP = 48
PREP_KW = dict(K=K, M=M, G=G, dt=CFG.dt, slop=CFG.contact_slop, baumgarte=CFG.baumgarte,
               restitution=CFG.restitution, bounce_thr=CFG.bounce_threshold)


def _spd(rng, n):
    a = rng.standard_normal((n, 3, 3)).astype(np.float32)
    return (0.3 * a @ a.transpose(0, 2, 1) + 0.2 * np.eye(3, dtype=np.float32)).reshape(n, 9)


def _inputs():
    rng = np.random.default_rng(41)
    x = rng.uniform(-2, 2, (NP, 3)).astype(np.float32)
    inv_m = rng.uniform(0.05, 0.3, NP).astype(np.float32)
    inv_m[::11] = 0.0                                    # static bodies
    v0 = rng.standard_normal((NP, 3)).astype(np.float32)
    w0 = rng.standard_normal((NP, 3)).astype(np.float32)
    II = _spd(rng, NP)
    pt3 = (np.repeat(x, C, axis=0).reshape(NP, C, 3)
           + rng.uniform(-0.6, 0.6, (NP, C, 3))).transpose(0, 2, 1).reshape(NP, 3 * C)
    depth = rng.uniform(-0.01, 0.05, (NP, C))
    hit = (rng.random((NP, C)) < 0.5).astype(np.float32)
    dh = np.concatenate([np.maximum(depth, 0), hit], 1)
    n = rng.standard_normal((NP, K, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    pn3 = n.transpose(0, 2, 1).reshape(NP, 3 * K)
    partner = rng.integers(0, NP, (NP, K))
    asleep = (rng.random(NP) < 0.25).astype(np.float32)
    btab = np.concatenate([x, inv_m[:, None], II, v0, w0, asleep[:, None]], 1)    # (NP, 20)
    btf = btab[partner].transpose(0, 2, 1).reshape(NP, 20 * K)
    own = np.concatenate([x, v0, w0, inv_m[:, None], II], 1)
    wake = (rng.random(NP) < 0.2).astype(np.float32)
    f = lambda a: np.ascontiguousarray(a, dtype=np.float32)  # noqa: E731
    return dict(pt3=f(pt3), dh=f(dh), pn3=f(pn3), btf=f(btf), own=f(own)), partner, v0, w0, wake


@pytest.fixture(scope="module")
def prep():
    ins, partner, v0, w0, wake = _inputs()
    jout = prep_contacts_pallas(*[jnp.asarray(v) for v in ins.values()], **PREP_KW, interpret=True)
    before = prep_cuda.launches
    got = prep_cuda.prep_contacts(*[torch.as_tensor(v) for v in ins.values()], **PREP_KW)
    assert prep_cuda.launches == before       # CPU tensors: the plain version, no launch
    return ins, partner, v0, w0, wake, [np.asarray(a) for a in jout], got


def _jax_tables(jout):
    """The JAX kernel's padded tables in the port's tight layout."""
    rA, rB, n, mt, hs, scale, iAI, vn0 = jout
    return [rA[:NP, : 3 * C], rB[:NP, : 3 * C], n[:NP, : 3 * C], mt[:NP, : 2 * C],
            hs[:NP, : 2 * C], scale[:NP, :2], iAI[:NP, :9], vn0[:NP]]


def test_prep_flags_exact(prep):
    *_, jout, got = prep
    np.testing.assert_array_equal(got[4].numpy(), _jax_tables(jout)[4])
    hs = got[4].numpy()
    assert hs[:, :C].any() and hs[:, C : C + K * M].any()   # hits, and sleeping partners


@pytest.mark.parametrize("i,name", [(0, "rA"), (1, "rB"), (2, "n"), (3, "m_eff|target"),
                                    (5, "scale"), (6, "inv_I"), (7, "vn0")])
def test_prep_tables_match(prep, i, name):
    *_, jout, got = prep
    want = _jax_tables(jout)[i]
    g = got[i].numpy()
    assert g.shape == want.shape, name
    np.testing.assert_array_less(np.abs(g - want), 1e-5 * np.maximum(1.0, np.abs(want)) + 1e-30)


@pytest.mark.parametrize("iters", [2, 8])     # 1 and 4 outer iterations of 2 substeps
def test_solver_matches(prep, iters):
    ins, partner, v0, w0, wake, jout, _ = prep
    tabs = _jax_tables(jout)[:7]
    Np_pad = jout[0].shape[0]
    vw0 = np.zeros((Np_pad, 8), np.float32)
    vw0[:NP, 0:3], vw0[:NP, 3:6], vw0[:NP, 6] = v0, w0, wake
    jv, jw, jwake, _ = solve_packed(
        jnp.asarray(vw0), jnp.asarray(partner), *[jnp.asarray(a) for a in jout[:7]], K=K, M=M,
        G=G, iters=iters, substeps=CFG.solver_substeps, mu=CFG.dynamic_friction, Np=NP,
        interpret=True)
    before = solver_cuda.launches
    got = solver_cuda.solve(torch.as_tensor(vw0[:NP]), torch.as_tensor(partner),
                            [torch.as_tensor(np.ascontiguousarray(a)) for a in tabs], K=K, M=M, G=G,
                            iters=iters, substeps=CFG.solver_substeps, mu=CFG.dynamic_friction)
    assert solver_cuda.launches == before
    got = got.numpy()
    want = np.concatenate([np.asarray(jv), np.asarray(jw)], 1)
    np.testing.assert_array_less(np.abs(got[:, :6] - want), 1e-5 * (1.0 + np.abs(want)))
    np.testing.assert_array_equal(got[:, 6] > 0.5, np.asarray(jwake))
    assert np.abs(got[:, :6] - np.concatenate([v0, w0], 1)).max() > 1e-3   # impulses applied
    assert (got[:, 6] > 0.5).sum() > (wake > 0.5).sum()                    # the wake spread


def _warm_lam(hit_slots):
    """Random accumulated impulses (NP, C, 3) = [λn ≥ 0, λu, λv], some on
    missed slots (the pre-apply masks them)."""
    rng = np.random.default_rng(43)
    lam = rng.standard_normal((NP, C, 3)).astype(np.float32) * 0.3
    lam[..., 0] = np.abs(lam[..., 0])
    return lam * ((hit_slots > 0.5) | (rng.random((NP, C)) < 0.2))[..., None]


def _lam_tol(jlam):
    """1e-5 × (1 + the slot's largest |λ|): the friction pair is rescaled
    into the cone μ·λn, so its rounding follows the slot's scale."""
    return np.broadcast_to(1e-5 * (1.0 + np.abs(jlam).max(-1, keepdims=True)), jlam.shape)


def _lam_slots(lam):
    """(Np, 3C) [λn | λu | λv] → (Np, C, 3)."""
    return lam.reshape(NP, 3, C).transpose(0, 2, 1)


@pytest.mark.parametrize("iters", [2, 8])     # 1 and 4 outer iterations of 2 substeps
def test_solver_accumulated_mode_matches(prep, iters):
    ins, partner, v0, w0, wake, jout, _ = prep
    tabs = _jax_tables(jout)[:7]
    Np_pad = jout[0].shape[0]
    lam0 = _warm_lam(tabs[4][:, :C])
    vw0 = np.zeros((Np_pad, 8), np.float32)
    vw0[:NP, 0:3], vw0[:NP, 3:6], vw0[:NP, 6] = v0, w0, wake
    jv, jw, jwake, jlam = solve_packed(
        jnp.asarray(vw0), jnp.asarray(partner), *[jnp.asarray(a) for a in jout[:7]], K=K, M=M,
        G=G, iters=iters, substeps=CFG.solver_substeps, mu=CFG.dynamic_friction, Np=NP,
        interpret=True, lam0=jnp.asarray(lam0))
    before = solver_cuda.warm_launches
    got, lam = solver_cuda.solve_warm(
        torch.as_tensor(vw0[:NP]), torch.as_tensor(lam0.transpose(0, 2, 1).reshape(NP, 3 * C)),
        torch.as_tensor(partner), [torch.as_tensor(np.ascontiguousarray(a)) for a in tabs], K=K,
        M=M, G=G, iters=iters, substeps=CFG.solver_substeps, mu=CFG.dynamic_friction)
    assert solver_cuda.warm_launches == before
    got = got.numpy()
    want = np.concatenate([np.asarray(jv), np.asarray(jw)], 1)
    np.testing.assert_array_less(np.abs(got[:, :6] - want), 1e-5 * (1.0 + np.abs(want)))
    np.testing.assert_array_equal(got[:, 6] > 0.5, np.asarray(jwake))
    jlam = np.asarray(jlam)
    np.testing.assert_array_less(np.abs(_lam_slots(lam.numpy()) - jlam), _lam_tol(jlam))
    assert np.abs(_lam_slots(lam.numpy()) - lam0).max() > 1e-3              # impulses moved
    assert (jlam[..., 0] >= 0).all()


@pytest.mark.parametrize("iters,substeps", [(4, 1), (8, 2)])
def test_warm_preapply_and_solve_match_prep_and_solve(prep, iters, substeps):
    ins, partner, v0, w0, wake, jout, got_tabs = prep
    lam0 = _warm_lam(_jax_tables(jout)[4][:, :C])
    kw = dict(PREP_KW, iters=iters, substeps=substeps, mu=CFG.dynamic_friction)
    jv, jw, jwake, jlam, *_ = prep_and_solve(
        *[jnp.asarray(v) for v in ins.values()], jnp.asarray(partner), jnp.asarray(v0),
        jnp.asarray(w0), jnp.asarray(wake), jnp.asarray(lam0), interpret=True, **kw)
    tables = got_tabs[:7]
    tv0, tw0, tlam0 = prep_cuda.warm_preapply(torch.as_tensor(v0), torch.as_tensor(w0),
                                              torch.as_tensor(lam0), tables, C=C)
    assert torch.equal(tlam0[..., 0] != 0, torch.as_tensor(lam0[..., 0] != 0)
                       & (tables[4][:, :C] > 0.5))                          # masked to hits
    vw0 = torch.cat([tv0, tw0, torch.as_tensor(wake)[:, None], torch.zeros((NP, 1))], 1)
    got, lam = solver_cuda.solve_warm(vw0, tlam0.permute(0, 2, 1).reshape(NP, 3 * C),
                                      torch.as_tensor(partner), tables, K=K, M=M, G=G,
                                      iters=iters, substeps=substeps, mu=CFG.dynamic_friction)
    got = got.numpy()
    want = np.concatenate([np.asarray(jv), np.asarray(jw)], 1)
    np.testing.assert_array_less(np.abs(got[:, :6] - want), 1e-5 * (1.0 + np.abs(want)))
    np.testing.assert_array_equal(got[:, 6] > 0.5, np.asarray(jwake))
    jlam = np.asarray(jlam)
    np.testing.assert_array_less(np.abs(_lam_slots(lam.numpy()) - jlam), _lam_tol(jlam))


def test_tangent_basis_matches():
    rng = np.random.default_rng(42)
    n = rng.standard_normal((3, 500)).astype(np.float32)
    n[:, :5] = [[0, 0, 1, 1, 0], [0, 1, 0, 1, 1], [1, 0, 0, 0, 1]]      # axis ties
    n /= np.linalg.norm(n, axis=0)
    got = solver_cuda.tangent_basis(*(torch.as_tensor(c) for c in n))
    want = j_tangent_basis(*(jnp.asarray(c) for c in n))
    for g3, w3 in zip(got, want):
        for g, w in zip(g3, w3):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("variant", ["pb_int32", "strided", "pb_int32_strided"])
@pytest.mark.parametrize("warm", [False, True], ids=["plain_mode", "accumulated_mode"])
def test_solve_bits_do_not_depend_on_partner_dtype_or_table_strides(prep, warm, variant):
    # ``solve`` and ``solve_warm`` check and convert the partner index, the
    # state and the tables once a solve (on the card, before its one
    # launch); the result must not depend on pb's integer type or on the
    # inputs' strides.
    _, partner, v0, w0, wake, _, got_tabs = prep
    tables = list(got_tabs[:7])
    vw0 = torch.cat([torch.as_tensor(v0), torch.as_tensor(w0), torch.as_tensor(wake)[:, None],
                     torch.zeros((NP, 1))], 1)
    lam0 = torch.as_tensor(np.ascontiguousarray(
        _warm_lam(tables[4][:, :C].numpy()).transpose(0, 2, 1).reshape(NP, 3 * C)))
    kw = dict(K=K, M=M, G=G, iters=8, substeps=CFG.solver_substeps, mu=CFG.dynamic_friction)

    def run(pb, vw, lam, tabs):
        out = solver_cuda.solve_warm(vw, lam, pb, tabs, **kw) if warm else \
            (solver_cuda.solve(vw, pb, tabs, **kw),)
        return [o.view(torch.int32) for o in out]

    base = run(torch.as_tensor(partner, dtype=torch.int64), vw0, lam0, tables)
    pb = torch.as_tensor(partner, dtype=torch.int32 if "int32" in variant else torch.int64)
    vw, lam, tabs = vw0, lam0, tables
    if "strided" in variant:
        vw, lam, *tabs = (t.T.contiguous().T for t in [vw0, lam0, *tables])
        assert not any(t.is_contiguous() for t in (vw, lam, *tabs))
    for g, w in zip(run(pb, vw, lam, tabs), base):
        assert torch.equal(g, w)


# --- B8's entry from the narrowphase's pair records ------------------------

R = 5 + 6 * M


def _bits_equal(a, b):
    """Bit for bit, NaN against NaN."""
    return a.shape == b.shape and bool(
        ((a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))).all())


def _record_inputs(seed=47, shape=(NP, K, M)):
    """Random inputs of ``prep_from_records`` at (Np, K, M): pair records
    with hit and missed points; a dead partner's slots (NaN depth, zero
    normal, no hit); pidx = -1 slots; sleeping and static (inv_m = 0)
    bodies; rows with no hit at all; ground contacts with and without
    hits."""
    NP, K, M = shape
    R = 5 + 6 * M
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (NP, 3)).astype(np.float32)
    raw = np.zeros((NP, K, R), np.float32)
    n = rng.standard_normal((NP, K, 3))
    raw[..., 0:3] = n / np.linalg.norm(n, axis=-1, keepdims=True)
    raw[..., 3] = rng.uniform(-0.01, 0.05, (NP, K))
    for m in range(M):
        raw[..., 5 + 6 * m] = rng.uniform(-0.01, 0.05, (NP, K))
        raw[..., 6 + 6 * m] = rng.random((NP, K)) < 0.5
        raw[..., 7 + 6 * m : 10 + 6 * m] = x[:, None] + rng.uniform(-0.6, 0.6, (NP, K, 3))
        raw[..., 10 + 6 * m] = rng.integers(1, 40, (NP, K))
    raw[..., 4] = raw[..., 6::6].max(-1)
    pidx = rng.integers(0, NP, (NP, K)).astype(np.int32)
    dead = rng.random((NP, K)) < 0.1
    raw[dead, 0:3] = 0.0
    raw[dead, 3] = np.nan
    raw[dead, 4] = 0.0
    raw[:, :, 5::6][dead] = np.nan
    raw[:, :, 6::6][dead] = 0.0
    empty = rng.random((NP, K)) < 0.1
    pidx[empty] = -1
    raw[:, :, 6::6][empty] = 0.0
    quiet = np.arange(NP) % 9 == 4                     # rows with no hit
    raw[quiet, :, 6::6] = 0.0
    g_pts = x[:, None] + rng.uniform(-0.6, 0.6, (NP, G, 3)).astype(np.float32)
    gd = rng.uniform(-0.02, 0.05, (NP, G)).astype(np.float32)
    g_hit = (gd > -CFG.contact_slop) & ~quiet[:, None] & (rng.random((NP, G)) < 0.8)
    inv_m = rng.uniform(0.05, 0.3, NP).astype(np.float32)
    inv_m[::11] = 0.0
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))  # noqa: E731
    return dict(raw=t(raw), pidx=t(pidx), g_pts=t(g_pts), gd=t(gd), g_hit=t(g_hit), x=t(x),
                v0=t(rng.standard_normal((NP, 3)).astype(np.float32)),
                w0=t(rng.standard_normal((NP, 3)).astype(np.float32)), inv_m=t(inv_m),
                inv_I=t(_spd(rng, NP)), asleep_in=t(rng.random(NP) < 0.25))


def _old_step_glue(raw, pidx, g_pts, gd, g_hit, x, v0, w0, inv_m, inv_I, asleep_in):
    """The slot tables as the single-piece step assembled them in PyTorch
    before B8 took that work (slot = m·K + k, then G ground slots)."""
    Np = pidx.shape[0]
    f32 = raw.dtype

    def rows(r):
        return raw[:, :, r::6][:, :, :M].permute(0, 2, 1).reshape(Np, M * K)

    val, mh, px, py, pz = (rows(r) for r in range(5, 10))
    pn3 = raw[:, :, 0:3].permute(0, 2, 1).reshape(Np, 3 * K)
    pt3 = torch.cat([px, g_pts[..., 0], py, g_pts[..., 1], pz, g_pts[..., 2]], dim=1)
    dh = torch.cat([torch.clamp(val, min=0.0), torch.clamp(gd, min=0.0), mh, g_hit.to(f32)],
                   dim=1)
    btab = torch.cat([x, inv_m[:, None], inv_I, v0, w0, asleep_in.to(f32)[:, None]], dim=1)
    pb = torch.clamp(pidx.long(), 0, Np - 1)
    btf = btab[pb].transpose(1, 2).reshape(Np, 20 * K)
    own = torch.cat([x, v0, w0, inv_m[:, None], inv_I], dim=1)
    return pt3, dh, pn3, btf, own


@pytest.mark.parametrize("seed", [47, 48])
def test_prep_from_records_equals_old_glue_then_prep(seed):
    ins = _record_inputs(seed)
    before = prep_cuda.launches
    got = prep_cuda.prep_from_records(*ins.values(), **PREP_KW)
    assert prep_cuda.launches == before       # CPU tensors: the plain version, no launch
    want = prep_cuda.prep_contacts_reference(*_old_step_glue(*ins.values()), **PREP_KW)
    for g, w in zip(got, want):
        assert _bits_equal(g, w)
    hs = got[4]
    quiet = torch.arange(NP) % 9 == 4
    assert (hs[quiet, :C] == 0).all() and (got[5][quiet, 1] == 1.0).all()   # no hit: split 1
    assert torch.isnan(got[3][:, C:]).any()                                  # dead partners
    assert (hs[:, C : C + K * M] == 1).any() and (hs[:, C : C + K * M] == 0).any()


def test_prep_from_records_matches_jax_step_glue_and_prep_pallas(monkeypatch):
    """The JAX package's single-piece glue (``_fused_prep_solve``, stopped
    after the prep at profile stage 35) and ``prep_contacts_pallas`` in
    interpret mode, against ``prep_from_records`` on the same records,
    bodies and world corners (the ground contacts taken from them on each
    side), at this file's tolerances."""
    rng = np.random.default_rng(49)
    ins = _record_inputs(49)
    raw = ins["raw"].numpy()
    cfg = dataclasses.replace(CFG, single_piece_bodies=True, max_hull_verts=8)
    sc = j_build_scene(j_cube_pieces(workload.lattice_offsets(NP)), cfg, max_bodies=NP)
    b = sc.bodies
    bodies = dataclasses.replace(
        b, x=jnp.asarray(ins["x"].numpy()),
        q=j_quat_normalize(jnp.asarray(rng.standard_normal((NP, 4)).astype(np.float32))),
        v=jnp.asarray(rng.standard_normal((NP, 3)).astype(np.float32)),
        w=jnp.asarray(rng.standard_normal((NP, 3)).astype(np.float32)),
        inv_mass=jnp.asarray(ins["inv_m"].numpy()))
    sleep = rng.integers(0, 2 * cfg.sleep_frames, NP).astype(np.int32)
    sc = dataclasses.replace(sc, bodies=bodies, sleep_frames=jnp.asarray(sleep))
    Vh = sc.piece_verts.shape[1]
    wverts = rng.uniform(-0.5, 0.5, (NP, Vh, 3)).astype(np.float32)
    wverts[..., 1] += cfg.ground_y + 0.45                  # some corners below the ground
    wmask = np.asarray(sc.piece_vmask)
    pvalid = np.ones(NP, bool)
    pvalid[3] = False

    seen = {}
    orig = j_prep.prep_contacts_pallas

    def rec(*a, **kw):
        seen["out"] = orig(*a, **kw)
        return seen["out"]

    monkeypatch.setattr(j_prep, "prep_contacts_pallas", rec)
    mpts = np.stack([raw[..., 7 + 6 * m : 10 + 6 * m] for m in range(M)], 2)
    mvals = np.stack([raw[..., 5 + 6 * m] for m in range(M)], 2)
    mhit = np.stack([raw[..., 6 + 6 * m] > 0.5 for m in range(M)], 2)
    j_step._fused_prep_solve(
        sc, cfg, 35, bodies, NP, K, G, M, jnp.asarray(wverts), jnp.asarray(wmask),
        jnp.arange(NP), jnp.asarray(pvalid), jnp.asarray(ins["pidx"].numpy()),
        jnp.asarray(mpts), jnp.asarray(mvals), jnp.asarray(mhit), jnp.asarray(raw[..., 0:3]),
        False)
    want = _jax_tables([np.asarray(a) for a in seen["out"]])

    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    ground = t_step._ground_contacts(cfg, t(wverts), t(wmask), t(pvalid))
    tb = types.SimpleNamespace(
        bodies=types.SimpleNamespace(v=t(bodies.v), w=t(bodies.w), inv_mass=ins["inv_m"],
                                     active=t(b.active)),
        sleep_frames=t(sleep))
    asleep_in, v0, w0 = t_step._start_velocities(tb, cfg)
    inv_I = world_inv_inertia(t(bodies.q), t(b.inv_inertia_body)).reshape(NP, 9)
    got = prep_cuda.prep_from_records(ins["raw"], ins["pidx"], *ground, ins["x"], v0, w0,
                                      ins["inv_m"], inv_I, asleep_in, **PREP_KW)
    assert bool(asleep_in.any()) and bool(ground[2].any())
    _assert_tables_close(got, want)


def _assert_tables_close(got, want):
    """hit | static exactly, every other table at this file's tolerance,
    NaN against NaN."""
    np.testing.assert_array_equal(got[4].numpy(), want[4])            # hit | static
    for i, name in [(0, "rA"), (1, "rB"), (2, "n"), (3, "m_eff|target"), (5, "scale"),
                    (6, "inv_I"), (7, "vn0")]:
        g, w = got[i].numpy(), want[i]
        assert g.shape == w.shape, name
        both_nan = np.isnan(g) & np.isnan(w)
        err = np.where(both_nan, 0.0, np.abs(g - w))
        np.testing.assert_array_less(err, 1e-5 * np.maximum(1.0, np.nan_to_num(np.abs(w)))
                                     + 1e-30, err_msg=name)


def test_prep_from_records_matches_prep_pallas_past_a_shared_row():
    """At K = 32, M = 64 on six rows (60,844 B a row: past the 48 KB of the
    kernel's shared variant, its wide variant on the card): ``prep_from_records``
    against ``prep_contacts_pallas`` in interpret mode on the slot tables
    of the same records (``slot_tables``, which the test above holds to the
    JAX step's glue; that glue at this shape costs 5 s more), at this
    file's tolerances."""
    shape = (6, 32, 64)
    kw = dict(PREP_KW, K=32, M=64)
    assert prep_cuda._variant(32, 64, G) == "wide"
    ins = _record_inputs(49, shape)
    got = prep_cuda.prep_from_records(*ins.values(), **kw)
    tabs = prep_cuda.slot_tables(*ins.values(), M=64)
    jout = prep_contacts_pallas(*[jnp.asarray(t.numpy()) for t in tabs], **kw, interpret=True)
    C = 32 * 64 + G
    rA, rB, n, mt, hs, scale, iAI, vn0 = (np.asarray(a) for a in jout)
    _assert_tables_close(got, [rA[:6, : 3 * C], rB[:6, : 3 * C], n[:6, : 3 * C],
                               mt[:6, : 2 * C], hs[:6, : 2 * C], scale[:6, :2], iAI[:6, :9],
                               vn0[:6]])
    assert (got[4][:, C : C + 32 * 64] == 1).any() and torch.isnan(got[3][:, C:]).any()
