"""The port's Scene layer on the CPU (every kernel's plain version) against
the JAX package's: scene queries, baking, velocity transfer, checkpoints,
``interactive_frame``, ``fire_impact`` and ``Scene.render``.

The configuration is ``tests/test_scene.py``'s, rendered at 128² so that
both raster passes take the tiled raster (kernel B11's plain version here,
the kernel on the card). The JAX reference runs compiled in a child process
with ``--xla_cpu_max_isa=AVX`` (no FMA contraction, as in the port) and
writes snapshots with its own ``save_scene``; the port starts from those, so
no random stream has to be reproduced.

Run as a script (``python tests/test_torch_scene.py OUT_DIR``) it writes
the JAX reference.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_threads import bounded_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FRACTURE = dict(initial_decompose_cell_cnt=12, max_pieces=96, max_faces=32, max_face_verts=16,
                max_piece_tris=96, max_active_pieces=8, partial_pattern_cell_cnt=24,
                general_pattern_cell_cnt=24, voronoi_neighbors=23)
PHYSICS = dict(broadphase_block=128)
RENDER = dict(width=128, height=128, shadow_size=128)
FRAMES = [((0.0, 10.0, 0.0), (0.0, -1.0, 0.0)),      # hits the cube: fractures
          ((100.0, 50.0, 0.0), (0.0, 1.0, 0.0))]     # misses: step and render only
IMPACT_RAY = ((0.0, 4.5, -10.0), (0.0, 0.0, 1.0))     # test_scene.py's impact
RAYS = [((0.0, 10.0, 0.0), (0.0, -1.0, 0.0)), ((0.0, 4.5, -10.0), (0.0, 0.0, 1.0)),
        ((10.0, 5.3, 0.2), (-1.0, 0.02, 0.0)), ((100.0, 100.0, 100.0), (0.0, 1.0, 0.0))]
OVERFLOWS = ("active_overflow", "job_overflow", "piece_overflow", "split_face_overflow")
COUNTS = ("new_pieces", "active_pieces", "merged_out", "num_groups", "mesh_tris_dropped")
# Body states: the rigid rebuild's float32 segment sums round differently
# from XLA's (x parts by ~1e-6); the JAX suite's trajectory tolerances.
X_ATOL, V_ATOL = 2e-4, 2e-3
# Images: a body position a few ulps off moves triangle edges and shadow
# taps by as much, which can flip the pixels whose centre lies on an edge;
# such a flip changes the colour by up to a whole shade. At least 99.5% of
# pixels agree within 1e-5.
IMG_ATOL, IMG_SHARE = 1e-5, 0.995


def _cfg(jax_side: bool):
    """The JAX package's SceneConfig, or the port's carried over from it."""
    from surtr_tpu.config import FractureConfig, PhysicsConfig, RenderConfig, SceneConfig

    cfg = SceneConfig(fracture=FractureConfig(**FRACTURE), physics=PhysicsConfig(**PHYSICS),
                      render=RenderConfig(**RENDER))
    if jax_side:
        return cfg
    from surtr_tpu_torch import convert

    return convert.scene_config_from(cfg)


def _with_random_bodies(phys, to):
    """``phys`` with unit quaternions, positions and velocities drawn from
    a fixed seed (``to`` makes arrays of the caller's package)."""
    import dataclasses

    B = phys.bodies.x.shape[0]
    rng = np.random.default_rng(1)
    q = rng.normal(size=(B, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x = rng.uniform(-2, 2, (B, 3)).astype(np.float32)
    v, w = (rng.normal(size=(B, 3)).astype(np.float32) for _ in range(2))
    return dataclasses.replace(phys, bodies=dataclasses.replace(
        phys.bodies, q=to(q), x=to(x), v=to(v), w=to(w)))


def _state(prefix, sc, res):
    for k in ("valid", "group", "tag", "mesh_valid"):
        res[f"{prefix}/{k}"] = np.asarray(getattr(sc.pieces, k))
    for k in ("x", "v", "w", "q", "active"):
        res[f"{prefix}/{k}"] = np.asarray(getattr(sc.phys.bodies, k))
    res[f"{prefix}/volume"] = np.asarray(sc.total_volume())


def _jax_reference(out_dir):
    """Child-process side: snapshots and every JAX result compared."""
    import dataclasses

    import jax.numpy as jnp
    from surtr_tpu.checkpoint import save_scene
    from surtr_tpu.physics.queries import raycast, sphere_overlap
    from surtr_tpu.physics.scene import build_scene
    from surtr_tpu.scene import Scene, _bake_pieces, _transfer_velocities

    res = {}
    sc = Scene("cube", _cfg(True))
    save_scene(os.path.join(out_dir, "init.npz"), sc)
    res["init/exact_caps"] = np.asarray(sc.cfg.fracture.exact_caps)
    for i, (o, d) in enumerate(RAYS):
        d = jnp.asarray(d, jnp.float32)
        d = d / jnp.linalg.norm(d)
        idx, t = raycast(sc.phys, jnp.asarray(o, jnp.float32), d)
        res[f"ray{i}/idx"], res[f"ray{i}/t"] = np.asarray(idx), np.asarray(t)
        res[f"ray{i}/overlap"] = np.asarray(
            sphere_overlap(sc.phys, jnp.asarray(o, jnp.float32) + d * 10.0, 0.5))

    # Bake the initial pieces under random body states.
    baked = _bake_pieces(sc.pieces, _with_random_bodies(sc.phys, jnp.asarray), sc._x0)
    res["bake/face_verts"] = np.asarray(baked.convex.face_verts)
    res["bake/planes"] = np.asarray(baked.convex.planes)
    res["bake/mesh"] = np.asarray(baked.mesh)

    # Frames from the initial snapshot: a hit, then a miss.
    for k, (o, d) in enumerate(FRAMES):
        img, met = sc.interactive_frame(o, d)
        res[f"frame{k}/img"] = np.asarray(img)
        for m, v in met.items():
            res[f"frame{k}/m/{m}"] = np.asarray(v)
        _state(f"frame{k}", sc, res)

    # Velocity transfer on the fractured pieces, random old body states.
    phys = _with_random_bodies(sc.phys, jnp.asarray)
    tag = np.where(np.asarray(sc.pieces.valid), np.arange(sc.pieces.P) % 5 - 1, -1)
    new = build_scene(sc.pieces, sc.cfg.physics)
    moved = _transfer_velocities(new, phys, sc.pieces.group, jnp.asarray(tag, jnp.int32),
                                 sc.pieces.valid)
    res["transfer/new_x"] = np.asarray(new.bodies.x)
    res["transfer/new_active"] = np.asarray(new.bodies.active)
    res["transfer/tag"] = tag
    res["transfer/v"], res["transfer/w"] = np.asarray(moved.bodies.v), np.asarray(moved.bodies.w)

    # fire_impact after 12 steps from the initial snapshot, then renders.
    sc = Scene("cube", _cfg(True))
    sc.step(12)
    save_scene(os.path.join(out_dir, "step12.npz"), sc)
    out = sc.fire_impact(*IMPACT_RAY)
    res["impact/targets"] = np.asarray(out["targets"])
    res["impact/point"] = out["impact"]
    for m, v in out["metrics"][0].items():
        res[f"impact/m/{m}"] = v
    _state("impact", sc, res)
    res["render/img"] = np.asarray(sc.render())
    res["render/wire"] = np.asarray(sc.render(wireframe=True))
    np.savez(os.path.join(out_dir, "ref.npz"), **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("scene_ref")
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)], env=env,
                          stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = dict(np.load(out / "ref.npz"))
    res["dir"] = str(out)
    return res


def _load(ref, name):
    """A snapshot loaded with the configuration the JAX Scene ran: its
    convex-model dispatch turned ``exact_caps`` off for the cube."""
    import dataclasses

    from surtr_tpu_torch.checkpoint import load_scene

    cfg = _cfg(False)
    cfg = dataclasses.replace(cfg, fracture=dataclasses.replace(cfg.fracture, exact_caps=False))
    return load_scene(os.path.join(ref["dir"], name), cfg, device="cpu")


def _assert_state(ref, prefix, sc):
    for k in ("valid", "group", "tag", "mesh_valid"):
        np.testing.assert_array_equal(getattr(sc.pieces, k).numpy(), ref[f"{prefix}/{k}"],
                                      err_msg=k)
    np.testing.assert_array_equal(sc.phys.bodies.active.numpy(), ref[f"{prefix}/active"])
    np.testing.assert_allclose(sc.total_volume(), float(ref[f"{prefix}/volume"]), rtol=1e-5)
    np.testing.assert_allclose(sc.phys.bodies.x.numpy(), ref[f"{prefix}/x"], atol=X_ATOL)
    for k in ("v", "w"):
        np.testing.assert_allclose(getattr(sc.phys.bodies, k).numpy(), ref[f"{prefix}/{k}"],
                                   atol=V_ATOL, err_msg=k)


def _assert_image(got, want):
    assert got.shape == want.shape
    close = (np.abs(got.numpy() - want) <= IMG_ATOL).all(-1)
    assert close.mean() >= IMG_SHARE, close.mean()


def _assert_metrics(ref, prefix, met):
    for k in OVERFLOWS:
        assert int(met[k]) == int(ref[f"{prefix}/m/{k}"]) == 0, k
    for k in COUNTS:
        assert int(met[k]) == int(ref[f"{prefix}/m/{k}"]), k
    np.testing.assert_allclose(float(met["total_volume"]), float(ref[f"{prefix}/m/total_volume"]),
                               rtol=1e-5)


def test_jax_snapshot_loads_into_the_port(ref):
    sc = _load(ref, "init.npz")
    data = np.load(os.path.join(ref["dir"], "init.npz"))
    np.testing.assert_array_equal(sc.pieces.convex.face_verts.numpy(),
                                  data["pieces:convex/face_verts"])
    np.testing.assert_array_equal(sc.pieces.mesh.numpy(), data["pieces:mesh"])
    np.testing.assert_array_equal(sc.ctx.partial_pattern.planes.numpy(),
                                  data["ctx:partial_pattern/planes"])
    np.testing.assert_array_equal(sc._x0.numpy(), data["x0:"])
    np.testing.assert_array_equal(sc.key, data["meta:key"])
    assert sc.num_bodies() == 1 and sc.num_pieces() == 12
    assert not bool(ref["init/exact_caps"])
    np.testing.assert_allclose(sc.total_volume(), 27.0, rtol=1e-3)


def test_port_snapshot_round_trip(ref, tmp_path):
    from surtr_tpu_torch.checkpoint import save_scene

    sc = _load(ref, "step12.npz")
    path = tmp_path / "port.npz"
    save_scene(str(path), sc)
    mine, theirs = np.load(path), np.load(os.path.join(ref["dir"], "step12.npz"))
    assert sorted(mine.keys()) == sorted(theirs.keys())
    for k in theirs.keys():
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
        assert mine[k].dtype == theirs[k].dtype, k
    back = _load(ref, str(path))
    assert back.time == pytest.approx(12 / 120)
    np.testing.assert_array_equal(back.phys.bodies.v.numpy(), theirs["bodies:v"])


@pytest.mark.parametrize("i", range(len(RAYS)))
def test_raycast_and_sphere_overlap_match(ref, i):
    from surtr_tpu_torch.physics.queries import raycast, sphere_overlap
    from surtr_tpu_torch.scene import _host_ray

    sc = _load(ref, "init.npz")
    o, d = _host_ray(*RAYS[i])
    idx, t = raycast(sc.phys, o, d)
    assert int(idx) == int(ref[f"ray{i}/idx"])
    np.testing.assert_allclose(float(t), float(ref[f"ray{i}/t"]), atol=1e-6)
    ov = sphere_overlap(sc.phys, o + d * 10.0, 0.5)
    np.testing.assert_array_equal(ov.numpy(), ref[f"ray{i}/overlap"])
    assert (int(idx) >= 0) == (i < 3)


@pytest.fixture(scope="module")
def frames(ref):
    sc = _load(ref, "init.npz")
    return [(sc.interactive_frame(o, d), {k: getattr(sc, k) for k in ("pieces", "phys")},
             sc.total_volume()) for o, d in FRAMES], sc


@pytest.mark.parametrize("k", range(len(FRAMES)))
def test_interactive_frame_matches(ref, frames, k):
    runs, _ = frames
    (img, met), state, volume = runs[k]
    _assert_metrics(ref, f"frame{k}", met)
    view = type("State", (), {})()
    view.pieces, view.phys, view.total_volume = state["pieces"], state["phys"], lambda: volume
    _assert_state(ref, f"frame{k}", view)
    _assert_image(img, ref[f"frame{k}/img"])
    if k == 0:
        assert int(met["new_pieces"]) > 0
    else:
        assert int(met["new_pieces"]) == 0 and int(met["active_pieces"]) == 0


def test_bake_pieces_matches(ref):
    from surtr_tpu_torch.scene import _bake_pieces

    sc = _load(ref, "init.npz")
    baked = _bake_pieces(sc.pieces, _with_random_bodies(sc.phys, torch.as_tensor), sc._x0)
    sm = sc.pieces.convex.slot_mask().numpy()[..., None]
    np.testing.assert_allclose(np.where(sm, baked.convex.face_verts.numpy(), 0),
                               np.where(sm, ref["bake/face_verts"], 0), atol=1e-6)
    np.testing.assert_allclose(baked.convex.planes.numpy(), ref["bake/planes"], atol=1e-6)
    np.testing.assert_allclose(baked.mesh.numpy(), ref["bake/mesh"], atol=1e-6)


def test_transfer_velocities_matches(ref, frames):
    import dataclasses

    from surtr_tpu_torch.physics.scene import build_scene
    from surtr_tpu_torch.scene import _transfer_velocities

    _, sc = frames
    old = _with_random_bodies(sc.phys, torch.as_tensor)
    new = build_scene(sc.pieces, sc.cfg.physics)
    # The JAX rebuild's positions, so that both sides transfer from the same bits.
    new = dataclasses.replace(new, bodies=dataclasses.replace(
        new.bodies, x=torch.as_tensor(ref["transfer/new_x"])))
    np.testing.assert_array_equal(new.bodies.active.numpy(), ref["transfer/new_active"])
    tag = torch.as_tensor(ref["transfer/tag"], dtype=torch.int32)
    moved = _transfer_velocities(new, old, sc.pieces.group, tag, sc.pieces.valid)
    np.testing.assert_allclose(moved.bodies.v.numpy(), ref["transfer/v"], atol=1e-6)
    np.testing.assert_allclose(moved.bodies.w.numpy(), ref["transfer/w"], atol=1e-6)
    # Some bodies inherit a velocity, the fresh-only ones stay at rest.
    speed = moved.bodies.v.abs().sum(1)
    assert (speed > 0).any() and (new.bodies.active & (speed == 0)).any()


@pytest.fixture(scope="module")
def impact(ref):
    sc = _load(ref, "step12.npz")
    return sc, sc.fire_impact(*IMPACT_RAY)


def test_fire_impact_matches(ref, impact):
    sc, out = impact
    assert out["targets"] == ref["impact/targets"].tolist() == [0]
    np.testing.assert_allclose(out["impact"], ref["impact/point"], atol=1e-5)
    met = {k: torch.as_tensor(v) for k, v in out["metrics"][0].items()}
    _assert_metrics(ref, "impact", met)
    _assert_state(ref, "impact", sc)
    assert sc.num_bodies() > 1


@pytest.mark.parametrize("wireframe", [False, True])
def test_scene_render_matches(ref, impact, wireframe):
    sc, _ = impact
    img = sc.render(wireframe=wireframe)
    _assert_image(img, ref["render/wire" if wireframe else "render/img"])
    bg = torch.tensor([0.12, 0.15, 0.18])
    assert ((img - bg).abs().sum(-1) > 0.01).float().mean() > 0.2
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0


def test_port_scene_init_and_miss():
    # The port's own decomposition (its torch.Generator seeds, not JAX's).
    from surtr_tpu_torch.scene import Scene

    sc = Scene("cube", _cfg(False), device="cpu")
    assert not sc.cfg.fracture.exact_caps
    assert sc.num_bodies() == 1 and sc.num_pieces() == 12
    np.testing.assert_allclose(sc.total_volume(), 27.0, rtol=1e-3)
    assert sc.fire_impact((100, 100, 100), (0, 1, 0)) == {}
    sc.step(2)
    st = sc.stats()
    assert st["pieces"] == 12 and st["bodies"] == 1 and st["max_speed"] > 0
    assert sc.positions().shape == (sc.phys.B, 3)


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
