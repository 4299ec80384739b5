"""The port's ``prepare_fracture`` on the CPU (every kernel's plain version)
against the JAX package's, with the same seeds.

The JAX reference runs compiled in a child process with
``--xla_cpu_max_isa=AVX``: on an AVX2 host XLA:CPU contracts the clip's
cut-point products ``a·s_b − b·s_a`` into FMAs, so the two faces sharing an
edge get cut points one ulp apart, the cap dedup keeps both, and caps carry
duplicate vertices (more fan triangles, so more ``mesh_tris_dropped``).
Without FMA every product is rounded, as in the port and its kernels, and
the two sides agree slot for slot. The test process's own XLA flags are
fixed by ``conftest.py`` before this file is imported, hence the child.

Run as a script (``python tests/test_torch_prepare.py CONFIG OUT.npz``) it
writes the JAX reference of one configuration; the fixture runs one child
per configuration, in parallel (each is mostly XLA compile time).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_threads import bounded_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASE = dict(
    max_faces=26, max_face_verts=16, voronoi_prefix=8,
    partial_pattern_cell_cnt=8, general_pattern_cell_cnt=8, exact_caps=False,
)
CONFIGS = {
    # Two-pass fold (6 + 8 of 37 planes), active-plane compaction (37 > 32).
    "cube32": ("cube", dict(BASE, initial_decompose_cell_cnt=32, max_pieces=128,
                            max_piece_tris=64, voronoi_neighbors=31)),
    # Non-convex model with the uncull mesh clip (Tp=128 keeps cull_cap at
    # the 320 source triangles) and mesh islands through the voxel merge.
    "blob32": ("blob", dict(BASE, initial_decompose_cell_cnt=32, max_pieces=32,
                            max_piece_tris=128, voronoi_neighbors=31)),
    # The culled pair-pool mesh clip: cull_cap 256 < the sphere's 320
    # triangles (no parity grid below 512); clip_polys_by_rows on the CPU.
    "sphere64": ("sphere", dict(BASE, initial_decompose_cell_cnt=64, max_pieces=64,
                                max_piece_tris=64, voronoi_neighbors=31)),
    # The ICH refit (refitting_point_limit 8 > 4: the batched B2's plain
    # version, then the k-DOP of its normals) on the legacy pool, and on
    # the exact caps' pool of a concave model.
    "cube16_refit8": ("cube", dict(BASE, initial_decompose_cell_cnt=16, max_pieces=16,
                                   voronoi_neighbors=15, refitting_point_limit=8)),
    "torus16_refit8": ("torus", dict(BASE, initial_decompose_cell_cnt=16, max_pieces=16,
                                     voronoi_neighbors=15, max_piece_tris=128,
                                     exact_caps=True, refitting_point_limit=8)),
    # The per-cell uniform-pool fallback of the culled mesh clip (320 >
    # cull_cap 256): clip_trisoup over each cell's own pool.
    "sphere16_nopool": ("sphere", dict(BASE, initial_decompose_cell_cnt=16, max_pieces=16,
                                       voronoi_neighbors=15, max_piece_tris=64,
                                       mesh_pair_pool=False)),
}
KEY = 46354


def _jax_reference(name, out_path):
    """Child-process side: run the JAX package on one configuration and save
    its outputs."""
    import jax
    import jax.numpy as jnp

    from surtr_tpu.config import FractureConfig
    from surtr_tpu.fracture.pattern import radial_seeds, uniform_seeds
    from surtr_tpu.fracture.pipeline import prepare_fracture
    from surtr_tpu.io.models import get_model, sphere_point_cloud
    from surtr_tpu.ops.moments import moments

    res = {}
    for name, (model, kw) in [(name, CONFIGS[name])]:
        cfg = FractureConfig(**kw)
        v, f = get_model(model)
        key = jax.random.PRNGKey(KEY)
        pieces, ctx, met = prepare_fracture(
            jnp.asarray(v), jnp.ones(len(v), bool), jnp.asarray(v[f]),
            jnp.ones(len(f), bool), jnp.asarray(sphere_point_cloud()), key, cfg)
        k0, k1, k2 = jax.random.split(key, 3)
        res[f"{name}/seeds"] = np.asarray(uniform_seeds(k0, cfg.initial_decompose_cell_cnt))
        res[f"{name}/pseeds"] = np.asarray(
            radial_seeds(k1, cfg.partial_pattern_cell_cnt, cfg.partial_pattern_dist))
        res[f"{name}/gseeds"] = np.asarray(
            radial_seeds(k2, cfg.general_pattern_cell_cnt, cfg.general_pattern_dist))
        for k, val in met.items():
            res[f"{name}/m/{k}"] = np.asarray(val)
        res[f"{name}/vol"] = np.asarray(moments(pieces.convex)[0])
        for f_ in ("face_verts", "n_verts", "planes"):
            res[f"{name}/{f_}"] = np.asarray(getattr(pieces.convex, f_))
        for f_ in ("mesh", "mesh_valid", "valid", "group", "tag"):
            res[f"{name}/{f_}"] = np.asarray(getattr(pieces, f_))
        res[f"{name}/bb_center"] = np.asarray(ctx.bb_center)
        res[f"{name}/mas"] = np.asarray(ctx.max_axis_scale)
        for pat in ("partial_pattern", "general_pattern"):
            p = getattr(ctx, pat)
            res[f"{name}/{pat}/n_verts"] = np.asarray(p.n_verts)
            res[f"{name}/{pat}/vol"] = np.asarray(moments(p)[0])
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("prepare_ref")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_cpu_max_isa=AVX"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = {
        name: subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), name, str(tmp / f"{name}.npz")],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for name in CONFIGS
    }
    ref = {}
    try:
        for name, proc in procs.items():
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            ref.update(np.load(tmp / f"{name}.npz"))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return ref


@pytest.fixture(scope="module")
def port_runs(jax_ref):
    from surtr_tpu_torch.config import FractureConfig
    from surtr_tpu_torch.fracture.pipeline import prepare_fracture
    from surtr_tpu_torch.io.models import get_model, sphere_point_cloud
    from surtr_tpu_torch.ops.moments import moments

    runs = {}
    for name, (model, kw) in CONFIGS.items():
        v, f = get_model(model)
        t = lambda a: torch.as_tensor(a)
        pieces, ctx, met = prepare_fracture(
            t(v), torch.ones(len(v), dtype=torch.bool), t(v[f]),
            torch.ones(len(f), dtype=torch.bool), t(sphere_point_cloud()),
            FractureConfig(**kw), t(jax_ref[f"{name}/seeds"]),
            t(jax_ref[f"{name}/pseeds"]), t(jax_ref[f"{name}/gseeds"]))
        runs[name] = (pieces, ctx, met, moments(pieces.convex)[0])
    return runs


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prepare_metrics_match(jax_ref, port_runs, name):
    _, _, met, _ = port_runs[name]
    for k in ("piece_cnt", "ich_face_cnt", "mesh_tris_dropped"):
        assert int(met[k]) == int(jax_ref[f"{name}/m/{k}"]), k
    # f32 sums of ~100 piece volumes in another order.
    np.testing.assert_allclose(float(met["total_volume"]),
                               float(jax_ref[f"{name}/m/total_volume"]), rtol=1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prepare_pieces_match(jax_ref, port_runs, name):
    pieces, _, _, vol = port_runs[name]
    r = lambda k: jax_ref[f"{name}/{k}"]
    mas = float(r("mas"))
    np.testing.assert_array_equal(pieces.valid.numpy(), r("valid"))
    np.testing.assert_array_equal(pieces.group.numpy(), r("group"))
    np.testing.assert_array_equal(pieces.tag.numpy(), r("tag"))
    # Pack order is by volume, so equal order means equal volumes; the
    # tolerance is f32 rounding of fan sums at the model's scale.
    np.testing.assert_allclose(vol.numpy(), r("vol"), atol=1e-6 * mas ** 3)
    np.testing.assert_array_equal(pieces.convex.n_verts.numpy(), r("n_verts"))
    sm = pieces.convex.slot_mask().numpy()[..., None]
    np.testing.assert_allclose(np.where(sm, pieces.convex.face_verts.numpy(), 0),
                               np.where(sm, r("face_verts"), 0), atol=1e-5 * mas)
    fm = pieces.convex.face_mask().numpy()[..., None]
    np.testing.assert_allclose(np.where(fm, pieces.convex.planes.numpy(), 0),
                               np.where(fm, r("planes"), 0), atol=1e-5 * mas)
    np.testing.assert_array_equal(pieces.mesh_valid.numpy(), r("mesh_valid"))
    mv = pieces.mesh_valid.numpy()[..., None, None]
    np.testing.assert_allclose(np.where(mv, pieces.mesh.numpy(), 0),
                               np.where(mv, r("mesh"), 0), atol=1e-5 * mas)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prepare_context_matches(jax_ref, port_runs, name):
    from surtr_tpu_torch.ops.moments import moments

    _, ctx, _, _ = port_runs[name]
    np.testing.assert_allclose(ctx.bb_center.numpy(), jax_ref[f"{name}/bb_center"], atol=1e-6)
    assert float(ctx.max_axis_scale) == pytest.approx(float(jax_ref[f"{name}/mas"]))
    for pat in ("partial_pattern", "general_pattern"):
        p = getattr(ctx, pat)
        np.testing.assert_array_equal(p.n_verts.numpy(), jax_ref[f"{name}/{pat}/n_verts"])
        np.testing.assert_allclose(moments(p)[0].numpy(), jax_ref[f"{name}/{pat}/vol"], atol=1e-6)


def test_prepare_out_of_slice_branches_raise(jax_ref, port_runs):
    """The branches that once raised (the ICH refit above limit 4 and the
    per-cell mesh-clip fallback) return, with the JAX package's piece count
    and a volume within rtol 1e-4 of its run; the fallback gives the pooled
    route's counts and volume."""
    from surtr_tpu_torch.config import FractureConfig
    from surtr_tpu_torch.fracture.pipeline import prepare_fracture
    from surtr_tpu_torch.io.models import get_model, sphere_point_cloud

    def run(model, **kw):
        v, f = get_model(model)
        corners = v[f]
        if "tile" in kw:
            corners = np.concatenate([corners] * kw.pop("tile"))
        cfg = FractureConfig(**dict(BASE, **kw))
        return prepare_fracture(
            torch.as_tensor(v), torch.ones(len(v), dtype=torch.bool),
            torch.as_tensor(corners), torch.ones(len(corners), dtype=torch.bool),
            torch.as_tensor(sphere_point_cloud()), cfg)

    small = dict(initial_decompose_cell_cnt=16, max_pieces=16, voronoi_neighbors=15)
    # Exact caps and the parity grid are ported: the calls return.
    _, _, met = run("cube", **dict(small, exact_caps=True))
    assert int(met["piece_cnt"]) == 16
    assert float(met["total_volume"]) == pytest.approx(27.0, rel=1e-3)
    # 516 source triangles and 64 cells build the grid.
    _, _, met = run("cube", tile=43, initial_decompose_cell_cnt=64, max_pieces=64,
                    voronoi_neighbors=15, max_piece_tris=256, max_islands=1)
    assert int(met["piece_cnt"]) == 64
    # The per-cell uniform-pool fallback (320 > cull_cap 256) and the ICH
    # refit at limit 8 return what the JAX package returns.
    for name in ("sphere16_nopool", "cube16_refit8"):
        _, _, met, _ = port_runs[name]
        assert int(met["piece_cnt"]) == int(jax_ref[f"{name}/m/piece_cnt"]) > 0
        np.testing.assert_allclose(float(met["total_volume"]),
                                   float(jax_ref[f"{name}/m/total_volume"]), rtol=1e-4)
    model, kw = CONFIGS["sphere16_nopool"]
    v, f = get_model(model)
    pooled = prepare_fracture(
        torch.as_tensor(v), torch.ones(len(v), dtype=torch.bool), torch.as_tensor(v[f]),
        torch.ones(len(f), dtype=torch.bool), torch.as_tensor(sphere_point_cloud()),
        FractureConfig(**dict(kw, mesh_pair_pool=True)),
        *(torch.as_tensor(jax_ref[f"sphere16_nopool/{k}"]) for k in ("seeds", "pseeds", "gseeds")))
    _, _, met, _ = port_runs["sphere16_nopool"]
    for k in ("piece_cnt", "mesh_tris_dropped"):
        assert int(met[k]) == int(pooled[2][k]), k
    np.testing.assert_allclose(float(met["total_volume"]), float(pooled[2]["total_volume"]),
                               rtol=1e-6)


def test_prepare_generator_seeds_are_deterministic():
    from surtr_tpu_torch.config import FractureConfig
    from surtr_tpu_torch.fracture.pipeline import prepare_fracture
    from surtr_tpu_torch.io.models import get_model, sphere_point_cloud

    v, f = get_model("cube")
    cfg = FractureConfig(**dict(BASE, initial_decompose_cell_cnt=16, max_pieces=16,
                                voronoi_neighbors=15))
    args = (torch.as_tensor(v), torch.ones(len(v), dtype=torch.bool), torch.as_tensor(v[f]),
            torch.ones(len(f), dtype=torch.bool), torch.as_tensor(sphere_point_cloud()), cfg)
    a = prepare_fracture(*args, generator=torch.Generator().manual_seed(1))[0]
    b = prepare_fracture(*args, generator=torch.Generator().manual_seed(1))[0]
    c = prepare_fracture(*args, generator=torch.Generator().manual_seed(2))[0]
    assert torch.equal(a.convex.face_verts, b.convex.face_verts)
    assert not torch.equal(a.convex.face_verts, c.convex.face_verts)
    assert int(a.valid.sum()) == 16


def test_density_sort_matches_jax():
    # The C > 128 seed order of the JAX package's prepare_fracture
    # (pipeline.py:609-618), written out here, against the port's.
    import jax.numpy as jnp

    from surtr_tpu_torch.fracture.pipeline import density_sort

    seeds = np.random.RandomState(12).uniform(-0.5, 0.5, (160, 3)).astype(np.float32)
    js = jnp.asarray(seeds)
    dmin = jnp.min(
        jnp.fill_diagonal(jnp.sum((js[:, None] - js[None]) ** 2, -1),
                          jnp.asarray(3.4e38, js.dtype), inplace=False),
        axis=1,
    )
    want = np.asarray(js[jnp.argsort(dmin)])
    np.testing.assert_array_equal(density_sort(torch.as_tensor(seeds)).numpy(), want)


if __name__ == "__main__":
    _jax_reference(sys.argv[1], sys.argv[2])
