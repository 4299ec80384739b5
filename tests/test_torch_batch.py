"""The port's batching on the CPU against the JAX package's: ``batch_decompose``
(BASELINE config 2's entry) at tests/test_batch.py's configuration on M = 4
boxes, with each mesh's seeds drawn as the JAX package draws them from its
key (``split(key, 3)``, as tests/test_torch_prepare.py does), and
``batch_step`` on tests/test_physics_batch.py's four scenes; and each batch
element bit for bit equal to its own single-mesh or single-scene run. The
sharded variants split the batch over two CPU "devices": each shard bit
for bit equal to its slice of the unsharded run, the tallies against the
JAX package's.

The JAX decomposition runs compiled in a child process with
``--xla_cpu_max_isa=AVX`` (no FMA contraction, as in the port; see
``test_torch_prepare.py``); run as a script (``python
tests/test_torch_batch.py OUT.npz``) it is that child. Tolerances: valid
flags and piece counts exactly, total and per-slot piece volumes within
rtol 1e-5; the stepped batch within the JAX suite's bound for its batch
against its single runs (atol 1e-6).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from surtr_tpu_torch import convert  # noqa: E402
from surtr_tpu_torch.config import FractureConfig  # noqa: E402
from torch_threads import bounded_threads  # noqa: E402, F401 (autouse)

CFG = dict(initial_decompose_cell_cnt=8, max_pieces=16, max_piece_tris=64, voronoi_neighbors=7,
           partial_pattern_cell_cnt=4, general_pattern_cell_cnt=4)   # tests/test_batch.py:13-20
M = 4


def _jax_reference(out_path):
    """Child-process side: the JAX package's batch_decompose on M boxes and
    the seeds each mesh drew."""
    import jax
    import jax.numpy as jnp

    from surtr_tpu.config import FractureConfig as JFractureConfig
    from surtr_tpu.fracture.batch import batch_decompose
    from surtr_tpu.fracture.pattern import radial_seeds, uniform_seeds
    from surtr_tpu.io.models import box, sphere_point_cloud
    from surtr_tpu.ops.moments import moments

    cfg = JFractureConfig(**CFG)
    v, f = box((2, 2, 2))
    keys = jax.random.split(jax.random.PRNGKey(0), M)
    pieces, met = batch_decompose(
        jnp.broadcast_to(jnp.asarray(v)[None], (M,) + v.shape), jnp.ones((M, len(v)), bool),
        jnp.broadcast_to(jnp.asarray(v[f])[None], (M,) + v[f].shape),
        jnp.ones((M, len(f)), bool), jnp.asarray(sphere_point_cloud()), keys, cfg)
    res = {f"m/{k}": np.asarray(val) for k, val in met.items()}
    res["vol"] = np.asarray(moments(pieces.convex)[0])
    res["valid"] = np.asarray(pieces.valid)
    seeds = {"seeds": [], "pseeds": [], "gseeds": []}
    for key in keys:
        k0, k1, k2 = jax.random.split(key, 3)
        seeds["seeds"].append(uniform_seeds(k0, cfg.initial_decompose_cell_cnt))
        seeds["pseeds"].append(radial_seeds(k1, cfg.partial_pattern_cell_cnt,
                                            cfg.partial_pattern_dist))
        seeds["gseeds"].append(radial_seeds(k2, cfg.general_pattern_cell_cnt,
                                            cfg.general_pattern_dist))
    res.update({k: np.stack([np.asarray(a) for a in v]) for k, v in seeds.items()})
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("batch_ref") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def _inputs():
    from surtr_tpu_torch.io.models import box, sphere_point_cloud

    v, f = box((2, 2, 2))
    vt, ct = torch.as_tensor(v), torch.as_tensor(v[f])
    return (vt.expand((M,) + vt.shape), torch.ones((M, len(v)), dtype=torch.bool),
            ct.expand((M,) + ct.shape), torch.ones((M, len(f)), dtype=torch.bool),
            torch.as_tensor(sphere_point_cloud()))


@pytest.fixture(scope="module")
def decomposed(jax_ref):
    from surtr_tpu_torch.fracture.batch import batch_decompose

    seeds = {k: torch.as_tensor(jax_ref[k]) for k in ("seeds", "pseeds", "gseeds")}
    return batch_decompose(*_inputs(), FractureConfig(**CFG), seeds=seeds["seeds"],
                           partial_seeds=seeds["pseeds"], general_seeds=seeds["gseeds"]), seeds


def test_batch_decompose_matches_jax(jax_ref, decomposed):
    from surtr_tpu_torch.ops.moments import moments

    (pieces, met), _ = decomposed
    assert pieces.valid.shape == (M, CFG["max_pieces"])
    assert met["piece_cnt"].shape == (M,)
    for k in ("piece_cnt", "ich_face_cnt", "mesh_tris_dropped"):
        np.testing.assert_array_equal(met[k].numpy(), jax_ref[f"m/{k}"], err_msg=k)
    np.testing.assert_allclose(met["total_volume"].numpy(), jax_ref["m/total_volume"], rtol=1e-5)
    np.testing.assert_allclose(met["total_volume"].numpy(), 8.0, rtol=1e-3)
    np.testing.assert_array_equal(pieces.valid.numpy(), jax_ref["valid"])
    vol = torch.where(pieces.valid, moments(pieces.convex)[0], 0.0).numpy()
    want = np.where(jax_ref["valid"], jax_ref["vol"], 0.0)
    np.testing.assert_allclose(vol, want, rtol=1e-5, atol=1e-6)
    # Each mesh its own seeds: different decompositions.
    assert not torch.equal(pieces.convex.face_verts[0], pieces.convex.face_verts[1])


def test_batch_elements_equal_their_single_runs(decomposed):
    from surtr_tpu_torch.fracture.pipeline import prepare_fracture
    from surtr_tpu_torch.types import index_tree

    (pieces, met), seeds = decomposed
    v, vm, tc, tm, cloud = _inputs()
    for i in (0, M - 1):
        one, _, m1 = prepare_fracture(v[i], vm[i], tc[i], tm[i], cloud, FractureConfig(**CFG),
                                      seeds["seeds"][i], seeds["pseeds"][i], seeds["gseeds"][i])
        got = index_tree(pieces, i)
        for f in ("mesh", "mesh_valid", "valid", "group", "tag"):
            assert torch.equal(getattr(got, f), getattr(one, f)), f
        for f in ("face_verts", "n_verts", "planes"):
            assert torch.equal(getattr(got.convex, f), getattr(one.convex, f)), f
        for k, val in m1.items():
            assert torch.equal(met[k][i], val), k


def test_batch_decompose_draws_seeds_from_a_generator():
    from surtr_tpu_torch.fracture.batch import batch_decompose

    cfg = FractureConfig(**CFG)
    a = batch_decompose(*_inputs(), cfg, generator=torch.Generator().manual_seed(3))[0]
    b = batch_decompose(*_inputs(), cfg, generator=torch.Generator().manual_seed(3))[0]
    assert torch.equal(a.convex.face_verts, b.convex.face_verts)
    assert not torch.equal(a.convex.face_verts[0], a.convex.face_verts[1])


def test_batch_step_matches_jax_and_single_runs():
    """tests/test_physics_batch.py's scenes: two stacked cubes at dx = 0.1·i."""
    from test_physics_batch import PCFG, _batch

    from surtr_tpu.physics.batch import batch_step as j_batch_step
    from surtr_tpu_torch.physics.batch import batch_step, stack_scenes, unstack_scenes
    from surtr_tpu_torch.physics.step import physics_step

    jbatch, _ = _batch(M)
    want = j_batch_step(jbatch, PCFG, n_steps=30)
    cfg = convert.physics_config_from(PCFG)
    batch = convert.scene_from(jbatch)
    assert batch.bodies.x.shape[0] == M
    got = batch_step(batch, cfg, n_steps=30)
    np.testing.assert_allclose(got.bodies.x.numpy(), np.asarray(want.bodies.x), atol=1e-6)
    np.testing.assert_allclose(got.bodies.v.numpy(), np.asarray(want.bodies.v), atol=1e-6)
    np.testing.assert_array_equal(got.sleep_frames.numpy(), np.asarray(want.sleep_frames))
    singles = unstack_scenes(batch)
    for i, s in enumerate(singles):
        for _ in range(30):
            s = physics_step(s, cfg)
        for f in dataclasses.fields(s.bodies):
            assert torch.equal(getattr(got.bodies, f.name)[i], getattr(s.bodies, f.name)), f.name
        assert torch.equal(got.sleep_frames[i], s.sleep_frames)
    restacked = stack_scenes(singles)
    for f in dataclasses.fields(batch):
        if f.name != "bodies":
            assert torch.equal(getattr(restacked, f.name), getattr(batch, f.name)), f.name


def _assert_same_tree(got, want):
    """Every tensor of two like containers bit for bit equal."""
    from surtr_tpu_torch.types import map_tree

    flat_g, flat_w = [], []
    map_tree(got, flat_g.append)
    map_tree(want, flat_w.append)
    assert len(flat_g) == len(flat_w)
    for i, (g, w) in enumerate(zip(flat_g, flat_w)):
        assert g.dtype == w.dtype and torch.equal(g, w), i


def test_sharded_batch_decompose_matches_batch_decompose_and_tally(jax_ref, decomposed):
    """Two CPU "devices" (the JAX suite's virtual devices' counterpart):
    each shard bit for bit equal to its meshes' slice of ``batch_decompose``
    (which the test above holds against the JAX package), the tally equal
    to the JAX package's Σ piece_cnt; seeds drawn from a generator as
    ``batch_decompose`` draws them; an uneven split raises."""
    from surtr_tpu_torch.fracture.batch import batch_decompose, sharded_batch_decompose
    from surtr_tpu_torch.types import index_tree

    (pieces, _), seeds = decomposed
    cfg = FractureConfig(**CFG)
    shards, total = sharded_batch_decompose(["cpu", "cpu"], *_inputs(), cfg,
                                            seeds=seeds["seeds"], partial_seeds=seeds["pseeds"],
                                            general_seeds=seeds["gseeds"])
    assert len(shards) == 2
    for i, shard in enumerate(shards):
        _assert_same_tree(shard, index_tree(pieces, slice(2 * i, 2 * i + 2)))
    assert total.shape == () and total.device.type == "cpu"
    assert int(total) == int(jax_ref["m/piece_cnt"].sum()) > 0
    drawn, _ = sharded_batch_decompose(["cpu", "cpu"], *_inputs(), cfg,
                                       generator=torch.Generator().manual_seed(3))
    whole, _ = batch_decompose(*_inputs(), cfg, generator=torch.Generator().manual_seed(3))
    for i, shard in enumerate(drawn):
        _assert_same_tree(shard, index_tree(whole, slice(2 * i, 2 * i + 2)))
    with pytest.raises(ValueError, match="evenly"):
        sharded_batch_decompose(["cpu"] * 3, *_inputs(), cfg, seeds=seeds["seeds"])


def test_sharded_batch_step_matches_jax_and_batch_step():
    """``__graft_entry__._tiny_scene``'s 16 cubes, four copies moving apart
    at different speeds, stepped 8 times over two devices: against the JAX
    package's ``sharded_batch_step`` on a 2-device CPU mesh (states within
    the JAX suite's batch bound, atol 1e-6; the activity within rtol 1e-5,
    f32 sums in other orders), each shard bit for bit equal to
    ``batch_step`` of its scenes, and the tally equal to the activity of
    the unsharded run."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import __graft_entry__ as ge
    from surtr_tpu.physics.batch import sharded_batch_step as j_sharded_batch_step
    from surtr_tpu_torch.physics.batch import activity, batch_step, sharded_batch_step
    from surtr_tpu_torch.types import index_tree

    scene, pcfg = ge._tiny_scene(16)
    n = 4
    jbatch = jax.tree_util.tree_map(lambda a: jnp.stack([a] * n), scene)
    kick = jnp.arange(n, dtype=jnp.float32)[:, None, None] * jnp.asarray([0.2, 0.0, 0.1])
    bodies = dataclasses.replace(jbatch.bodies, v=jbatch.bodies.v + kick)
    jbatch = dataclasses.replace(jbatch, bodies=bodies)
    mesh = Mesh(np.asarray(jax.devices("cpu")[:2]), ("data",))
    want, want_act = j_sharded_batch_step("data", mesh, jbatch, pcfg, n_steps=8)

    batch = convert.scene_from(jbatch)
    cfg = convert.physics_config_from(pcfg)
    shards, act = sharded_batch_step(["cpu", "cpu"], batch, cfg, n_steps=8)
    assert len(shards) == 2
    x = torch.cat([s.bodies.x for s in shards])
    v = torch.cat([s.bodies.v for s in shards])
    np.testing.assert_allclose(x.numpy(), np.asarray(want.bodies.x), atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(want.bodies.v), atol=1e-6)
    assert act.shape == () and act.dtype == torch.float32
    np.testing.assert_allclose(float(act), float(want_act), rtol=1e-5)
    whole = batch_step(batch, cfg, n_steps=8)
    for i, shard in enumerate(shards):
        _assert_same_tree(shard, index_tree(whole, slice(2 * i, 2 * i + 2)))
    assert torch.equal(act, activity(whole).float()) and float(act) > 0


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
