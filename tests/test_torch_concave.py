"""The port's concave-model path on the CPU (every kernel's plain version)
against the JAX package's: ``prepare_fracture`` with exact closed-mesh caps
on the blob (32 cells, ray-parity cap probes) and on the torus (64 cells
and 576 triangles: the prepare-time parity grid and the culled pair-pool
mesh clip), ``do_fracture`` with exact caps on a prepared blob (each
candidate's solid its source piece's capped mesh), and ``Scene("blob")``,
which keeps exact caps for a concave model, firing one impact.

The JAX reference runs compiled in child processes with
``--xla_cpu_max_isa=AVX`` (no FMA contraction, as in the port; see
``test_torch_prepare.py``), one per case, in parallel. The prepare cases
share the JAX package's seeds; the fracture and Scene cases start the port
from the JAX package's own prepared pieces and snapshot. Run as a script
(``python tests/test_torch_concave.py CASE OUT_DIR``) it is one child.

Tolerances: counts, overflow counters, ``valid``, groups, tags and mesh
masks exactly; total volumes within rtol 1e-5; piece volumes within
1e-6 × scale³, face vertices, planes and mesh corners within 1e-5 × scale
(float32 sums in another order); bodies and images as
``test_torch_scene.py`` compares them.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_fracture import _flatten, _unflatten  # noqa: E402
from test_torch_scene import (COUNTS, FRACTURE, IMG_ATOL, IMG_SHARE, OVERFLOWS,  # noqa: E402
                              PHYSICS, RENDER, V_ATOL, X_ATOL)
from torch_threads import bounded_threads  # noqa: E402, F401 (autouse)

BASE = dict(max_faces=26, max_face_verts=16, voronoi_prefix=8, max_piece_tris=128,
            voronoi_neighbors=31, partial_pattern_cell_cnt=8, general_pattern_cell_cnt=8)
PREPARE = {
    "blob32": ("blob", dict(BASE, initial_decompose_cell_cnt=32, max_pieces=32)),
    # cull_cap = 4·128 = 512 < 576 triangles, and C >= 64 with >= 512
    # triangles: the parity grid.
    "torus64": ("torus", dict(BASE, initial_decompose_cell_cnt=64, max_pieces=64)),
}
FRACTURE_CFG = dict(BASE, initial_decompose_cell_cnt=16, max_pieces=96, max_active_pieces=8,
                    partial_pattern_cell_cnt=16)
FRACTURE_IMPACT = (1.0, 0.5, 0.5)
SCENE_RAY = ((0.0, 10.0, 0.0), (0.0, -1.0, 0.0))     # down onto the blob at y = 5
KEY = 46354
CASES = (*PREPARE, "fracture", "scene")


def _mesh_volume(model):
    from surtr_tpu_torch.io.models import get_model

    v, f = get_model(model)
    v = v.astype(np.float64)
    return float(np.einsum("ij,ij->i", v[f[:, 0]], np.cross(v[f[:, 1]], v[f[:, 2]])).sum() / 6)


def _scene_cfg(jax_side: bool):
    from surtr_tpu.config import FractureConfig, PhysicsConfig, RenderConfig, SceneConfig

    cfg = SceneConfig(fracture=FractureConfig(**FRACTURE), physics=PhysicsConfig(**PHYSICS),
                      render=RenderConfig(**RENDER))
    if jax_side:
        return cfg
    from surtr_tpu_torch import convert

    return convert.scene_config_from(cfg)


def _jax_reference(case, out_dir):
    """Child-process side: one case of the JAX package, saved to OUT_DIR."""
    import jax
    import jax.numpy as jnp

    from surtr_tpu.config import FractureConfig
    from surtr_tpu.fracture.pattern import radial_seeds, uniform_seeds
    from surtr_tpu.fracture.pipeline import do_fracture, prepare_fracture
    from surtr_tpu.io.models import get_model, sphere_point_cloud
    from surtr_tpu.ops.moments import moments

    def prepare(model, cfg, key):
        v, f = get_model(model)
        return prepare_fracture(
            jnp.asarray(v), jnp.ones(len(v), bool), jnp.asarray(v[f]), jnp.ones(len(f), bool),
            jnp.asarray(sphere_point_cloud()), key, cfg)

    res = {}
    if case in PREPARE:
        model, kw = PREPARE[case]
        cfg = FractureConfig(**kw)
        key = jax.random.PRNGKey(KEY)
        pieces, _, met = prepare(model, cfg, key)
        k0, k1, k2 = jax.random.split(key, 3)
        res["seeds"] = np.asarray(uniform_seeds(k0, cfg.initial_decompose_cell_cnt))
        res["pseeds"] = np.asarray(
            radial_seeds(k1, cfg.partial_pattern_cell_cnt, cfg.partial_pattern_dist))
        res["gseeds"] = np.asarray(
            radial_seeds(k2, cfg.general_pattern_cell_cnt, cfg.general_pattern_dist))
        for k, val in met.items():
            res[f"m/{k}"] = np.asarray(val)
        res["vol"] = np.asarray(moments(pieces.convex)[0])
        _flatten("out", pieces, res)
    elif case == "fracture":
        cfg = FractureConfig(**FRACTURE_CFG)
        pieces, ctx, _ = prepare("blob", cfg, jax.random.PRNGKey(cfg.seed))
        _flatten("in/pieces", pieces, res)
        _flatten("in/ctx", ctx, res)
        out, met = do_fracture(pieces, ctx, jnp.asarray(FRACTURE_IMPACT, jnp.float32), 0, cfg,
                               partial=True)
        _flatten("out", out, res)
        for k, val in met.items():
            res[f"m/{k}"] = np.asarray(val)
    else:
        from surtr_tpu.checkpoint import save_scene
        from surtr_tpu.scene import Scene

        sc = Scene("blob", _scene_cfg(True))
        res["exact_caps"] = np.asarray(sc.cfg.fracture.exact_caps)
        save_scene(os.path.join(out_dir, "init.npz"), sc)
        out = sc.fire_impact(*SCENE_RAY)
        res["impact"], res["targets"] = out["impact"], np.asarray(out["targets"])
        for m, v in out["metrics"][0].items():
            res[f"m/{m}"] = v
        for k in ("valid", "group", "tag", "mesh_valid"):
            res[k] = np.asarray(getattr(sc.pieces, k))
        for k in ("x", "v", "w", "active"):
            res[k] = np.asarray(getattr(sc.phys.bodies, k))
        res["volume"] = np.asarray(sc.total_volume())
        res["img"] = np.asarray(sc.render())
    np.savez(os.path.join(out_dir, "ref.npz"), **res)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("concave_ref")
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = {}
    for case in CASES:
        (tmp / case).mkdir()
        procs[case] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, str(tmp / case)], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    ref = {}
    try:
        for case, proc in procs.items():
            _, err = proc.communicate(timeout=900)
            assert proc.returncode == 0, err[-4000:]
            ref[case] = dict(np.load(tmp / case / "ref.npz"))
            ref[case]["dir"] = str(tmp / case)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return ref


def _assert_pieces(got, r, mas):
    np.testing.assert_array_equal(got.valid.numpy(), r("valid"))
    np.testing.assert_array_equal(got.group.numpy(), r("group"))
    np.testing.assert_array_equal(got.tag.numpy(), r("tag"))
    np.testing.assert_array_equal(got.convex.n_verts.numpy(), r("convex/n_verts"))
    sm = got.convex.slot_mask().numpy()[..., None]
    np.testing.assert_allclose(np.where(sm, got.convex.face_verts.numpy(), 0),
                               np.where(sm, r("convex/face_verts"), 0), atol=1e-5 * mas)
    fm = got.convex.face_mask().numpy()[..., None]
    np.testing.assert_allclose(np.where(fm, got.convex.planes.numpy(), 0),
                               np.where(fm, r("convex/planes"), 0), atol=1e-5 * mas)
    np.testing.assert_array_equal(got.mesh_valid.numpy(), r("mesh_valid"))
    mv = got.mesh_valid.numpy()[..., None, None]
    np.testing.assert_allclose(np.where(mv, got.mesh.numpy(), 0), np.where(mv, r("mesh"), 0),
                               atol=1e-5 * mas)


@pytest.fixture(scope="module")
def prepared(jax_ref):
    from surtr_tpu_torch import workload
    from surtr_tpu_torch.config import FractureConfig
    from surtr_tpu_torch.fracture import pipeline

    runs = {}
    for name, (model, kw) in PREPARE.items():
        r = jax_ref[name]
        grids = []
        orig = pipeline.build_parity_grid
        pipeline.build_parity_grid = lambda *a, **k: grids.append(orig(*a, **k)) or grids[-1]
        try:
            out = pipeline.prepare_fracture(
                *workload.model_inputs(model, "cpu"), FractureConfig(**kw),
                *(torch.as_tensor(r[k]) for k in ("seeds", "pseeds", "gseeds")))
        finally:
            pipeline.build_parity_grid = orig
        runs[name] = out, len(grids)
    return runs


@pytest.mark.parametrize("name", list(PREPARE))
def test_concave_prepare_metrics_match(jax_ref, prepared, name):
    (_, _, met), _ = prepared[name]
    r = jax_ref[name]
    for k in ("piece_cnt", "ich_face_cnt", "mesh_tris_dropped"):
        assert int(met[k]) == int(r[f"m/{k}"]), k
    np.testing.assert_allclose(float(met["total_volume"]), float(r["m/total_volume"]), rtol=1e-5)


@pytest.mark.parametrize("name", list(PREPARE))
def test_concave_prepare_pieces_match(jax_ref, prepared, name):
    from surtr_tpu_torch.ops.moments import moments

    (pieces, ctx, _), n_grids = prepared[name]
    r = jax_ref[name]
    mas = float(ctx.max_axis_scale)
    np.testing.assert_allclose(moments(pieces.convex)[0].numpy(), r["vol"], atol=1e-6 * mas ** 3)
    _assert_pieces(pieces, lambda k: r[f"out/{k}"], mas)
    # The torus reaches the parity grid (C >= 64, 576 >= 512), the blob not.
    assert n_grids == (name == "torus64")


def test_prepare_nonconvex_volume_bounds():
    """The mirror of ``tests/test_fracture.py``'s test with the port's own
    seeds: exact-caps pieces of the blob cover at least 95% of its mesh
    volume and at most 1.6 times it (the ACH overshoots concavities)."""
    from surtr_tpu_torch import workload
    from surtr_tpu_torch.config import FractureConfig
    from surtr_tpu_torch.fracture.pipeline import prepare_fracture
    from surtr_tpu_torch.ops.moments import moments

    cfg = FractureConfig(initial_decompose_cell_cnt=16, max_pieces=128, max_faces=32,
                         max_face_verts=16, max_piece_tris=128, max_active_pieces=8,
                         partial_pattern_cell_cnt=32, general_pattern_cell_cnt=32,
                         voronoi_neighbors=31)
    assert cfg.exact_caps
    pieces, _, _ = prepare_fracture(*workload.model_inputs("blob", "cpu"), cfg)
    total = float(torch.where(pieces.valid, moments(pieces.convex)[0], 0.0).sum())
    mesh_vol = _mesh_volume("blob")
    assert mesh_vol * 0.95 <= total <= mesh_vol * 1.6


@pytest.fixture(scope="module")
def fractured(jax_ref):
    from surtr_tpu_torch import convert
    from surtr_tpu_torch.config import FractureConfig
    from surtr_tpu_torch.fracture import pipeline

    r = jax_ref["fracture"]
    pieces = convert.pieces_from(_unflatten(r, "in/pieces"))
    ctx = convert.context_from(_unflatten(r, "in/ctx"))
    return pipeline.do_fracture(pieces, ctx, torch.tensor(FRACTURE_IMPACT), 0,
                                FractureConfig(**FRACTURE_CFG), partial=True), ctx


def test_concave_do_fracture_matches(jax_ref, fractured):
    (out, met), ctx = fractured
    r = jax_ref["fracture"]
    for k in OVERFLOWS:
        assert int(met[k]) == int(r[f"m/{k}"]) == 0, k
    for k in COUNTS:
        assert int(met[k]) == int(r[f"m/{k}"]), k
    np.testing.assert_allclose(float(met["total_volume"]), float(r["m/total_volume"]), rtol=1e-5)
    assert int(met["new_pieces"]) > 0
    _assert_pieces(out, lambda k: r[f"out/{k}"], float(ctx.max_axis_scale))


def test_concave_scene_fire_impact_matches(jax_ref):
    """A JAX-built ``Scene("blob")`` snapshot (exact caps kept) loaded into
    the port. ``fire_impact``: the same targets, the impact point within
    1e-5 (the raycast's t within an ulp) and the same counts. The event
    itself from the JAX package's impact point (``impact_at``), on both
    sides: pieces, bodies and a render as ``test_torch_scene.py`` compares
    them. An exact cap decision can turn on one ulp of the impact point,
    so the event is compared from the same point."""
    from surtr_tpu_torch.checkpoint import load_scene

    r = jax_ref["scene"]
    assert bool(r["exact_caps"])
    cfg = _scene_cfg(False)
    assert cfg.fracture.exact_caps
    load = lambda: load_scene(os.path.join(r["dir"], "init.npz"), cfg, device="cpu")  # noqa: E731
    fired = load().fire_impact(*SCENE_RAY)
    assert fired["targets"] == r["targets"].tolist()
    np.testing.assert_allclose(fired["impact"], r["impact"], atol=1e-5)
    for k in (*OVERFLOWS, *COUNTS):
        assert int(fired["metrics"][0][k]) == int(r[f"m/{k}"]), k

    sc = load()
    met = sc.impact_at(r["impact"], r["targets"].tolist())["metrics"][0]
    for k in OVERFLOWS:
        assert int(met[k]) == int(r[f"m/{k}"]) == 0, k
    for k in COUNTS:
        assert int(met[k]) == int(r[f"m/{k}"]), k
    assert int(met["new_pieces"]) > 0
    for k in ("valid", "group", "tag", "mesh_valid"):
        np.testing.assert_array_equal(getattr(sc.pieces, k).numpy(), r[k], err_msg=k)
    np.testing.assert_array_equal(sc.phys.bodies.active.numpy(), r["active"])
    np.testing.assert_allclose(sc.total_volume(), float(r["volume"]), rtol=1e-5)
    np.testing.assert_allclose(sc.phys.bodies.x.numpy(), r["x"], atol=X_ATOL)
    for k in ("v", "w"):
        np.testing.assert_allclose(getattr(sc.phys.bodies, k).numpy(), r[k], atol=V_ATOL)
    img = sc.render()
    assert img.shape == r["img"].shape
    assert ((np.abs(img.numpy() - r["img"]) <= IMG_ATOL).all(-1)).mean() >= IMG_SHARE


def test_port_concave_scene_keeps_exact_caps():
    """The port's own ``Scene("blob")`` (its torch.Generator seeds) keeps
    exact caps, fires an impact through them, steps, renders and runs one
    ``interactive_frame``."""
    from surtr_tpu_torch.scene import Scene

    sc = Scene("blob", _scene_cfg(False), device="cpu")
    assert sc.cfg.fracture.exact_caps
    v0 = sc.total_volume()
    assert 0.95 * _mesh_volume("blob") <= v0 <= 1.6 * _mesh_volume("blob")
    met = sc.fire_impact(*SCENE_RAY)["metrics"][0]
    assert int(met["new_pieces"]) > 0 and sc.num_bodies() > 1
    sc.step(2)
    img = sc.render()
    assert bool(torch.isfinite(img).all()) and float(img.max()) <= 1.0
    img, met = sc.interactive_frame(*SCENE_RAY)
    assert bool(torch.isfinite(img).all()) and int(met["piece_overflow"]) == 0


if __name__ == "__main__":
    _jax_reference(sys.argv[1], sys.argv[2])
