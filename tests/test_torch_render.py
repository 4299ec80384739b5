"""The port's renderer on the CPU (kernel B11's plain version) against the
JAX package's.

The JAX reference runs compiled in a child process with
``--xla_cpu_max_isa=AVX`` (no FMA contraction, as in the port; see
``test_torch_prepare.py``): there the camera matrices, the projection, the
near clips and the rasters agree with the port bit for bit. Inputs are made
with numpy from fixed seeds.

Run as a script (``python tests/test_torch_render.py OUT.npz``) it writes
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

LIGHT = (-0.4, -1.0, -0.3)
CAMERAS = {  # name: (eye, target, fov, aspect, znear, zfar)
    "bench": ((8.0, 6.0, 8.0), (0.0, 0.0, 0.0), 45.0, 1.0, 0.1, 100.0),
    "frame": ((8.0, 6.0, 8.0), (0.0, 1.0, 0.0), 45.0, 1.0, 0.01, 500.0),
    "near": ((0.3, 0.2, 0.6), (0.0, 0.0, 0.0), 45.0, 1.5, 0.1, 50.0),
    # XLA:CPU's float32 tan is not correctly rounded (at 30° it is one ulp
    # above PyTorch's), so this matrix agrees within the tolerance only.
    "wide": ((0.3, 0.2, 0.6), (0.0, 0.0, 0.0), 60.0, 1.5, 0.1, 50.0),
}
LIGHTS = {  # name: (light_dir, center, radius); "down" takes the (1, 0, 0) up vector
    "frame": (LIGHT, (0.0, 1.0, 0.0), 14.0),
    "bench": (LIGHT, (0.0, 0.0, 0.0), 8.0),
    "down": ((0.0, -1.0, 0.01), (0.0, 1.0, 0.0), 6.0),
}
# B11 cases at W = 256, H = 64 (2 × 4 tiles): name → (seed, T, with G-buffer).
RASTER_CASES = {
    "random": (3, 160, False),
    "random_gbuf": (3, 160, True),
    "T40_gbuf": (5, 40, True),
    "T100": (6, 100, False),
    "none_valid": (7, 96, True),
}
RW, RH = 256, 64
# render_scene: name → (W, H, shadow, mode); 96² takes the sweep on both
# sides, 128² the tiled raster on the port and the sweep in the JAX package.
RENDERS = {
    "deferred96": (96, 96, 64, "deferred"),
    "normals96": (96, 96, 64, "normals"),
    "wireframe96": (96, 96, 64, "wireframe"),
    "deferred128": (128, 128, 128, "deferred"),
    "normals128": (128, 128, 128, "normals"),
}
# Images: a pixel whose centre lies within rounding of a triangle edge, or a
# PCF tap on a shadow-map texel border, may flip between the two sides when
# the tiled raster and the sweep pick different triangles at equal depth; a
# flip changes the colour by up to the triangle's whole shade. So at least
# 99.5% of pixels must agree within 1e-5 (in practice all do at 96²).
IMG_ATOL, IMG_SHARE = 1e-5, 0.995


def _scene_tris(seed=3, T=160):
    """test_render.py's cloud: T triangles about the origin, the first a
    screen-large ground triangle that straddles the near plane."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-3, 3, (T, 1, 3)).astype(np.float32)
    tris = centers + rng.normal(0, 0.4, (T, 3, 3)).astype(np.float32)
    tris[0] = [[-30, -2, -30], [-30, -2, 30], [30, -2, 30]]
    return tris


def _near_cloud():
    """2,400 large triangles about the "near" camera's eye, 10% invalid:
    one- and two-inside triangles abound and the second-piece pool (300
    rows) overflows."""
    rng = np.random.default_rng(11)
    tris = rng.uniform(-2, 2, (2400, 1, 3)) + rng.normal(0, 1.0, (2400, 3, 3))
    return tris.astype(np.float32), rng.uniform(size=2400) > 0.1


def _raster_inputs(name):
    """Screen-space triangles for B11: random ones, one covering the screen
    at depth 0.9, an exact duplicate (a depth tie: the first wins), an
    invalid one, one off screen; "none_valid" marks every one invalid."""
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


def _camera(name):
    import jax.numpy as jnp
    from surtr_tpu.render.camera import look_at, perspective

    eye, target, fov, aspect, zn, zf = CAMERAS[name]
    return perspective(fov, aspect, zn, zf) @ look_at(jnp.asarray(eye), jnp.asarray(target))


def _jax_reference(out_path):
    """Child-process side: every JAX result the tests compare with."""
    import jax.numpy as jnp
    from surtr_tpu.render.camera import light_view_proj, look_at, ortho, perspective
    from surtr_tpu.render.raster import (_near_clip_full, _near_clip_pooled, _project,
                                         _screen, near_clip, raster_screen, rasterize_ids,
                                         render_scene)
    from surtr_tpu.render.raster_pallas import rasterize_ids_pallas

    res = {}
    for name, (eye, target, fov, aspect, zn, zf) in CAMERAS.items():
        res[f"cam/{name}/look_at"] = look_at(jnp.asarray(eye), jnp.asarray(target))
        res[f"cam/{name}/perspective"] = perspective(fov, aspect, zn, zf)
        res[f"cam/{name}/vp"] = _camera(name)
    for name, (d, c, r) in LIGHTS.items():
        res[f"light/{name}"] = light_view_proj(jnp.asarray(d), c, r)
    res["ortho"] = ortho(-3.0, 5.0, -2.0, 4.0, 0.5, 20.0)

    tris, valid = _near_cloud()
    clip = _project(jnp.asarray(tris), _camera("near"))
    aux = jnp.asarray(tris)
    c2, a2, v2 = _near_clip_full(clip, jnp.asarray(valid), aux)
    res["nc/clip"], res["nc/full_clip"], res["nc/full_aux"], res["nc/full_ok"] = clip, c2, a2, v2
    res["nc/pool_clip"], res["nc/pool_ok"], res["nc/pool_src"] = _near_clip_pooled(
        clip, jnp.asarray(valid))

    for name in RASTER_CASES:
        sx, sy, sz, ok, attr = _raster_inputs(name)
        out = rasterize_ids_pallas(jnp.asarray(sx), jnp.asarray(sy), jnp.asarray(sz),
                                   jnp.asarray(ok), RW, RH,
                                   attr_tab=None if attr is None else jnp.asarray(attr),
                                   interpret=True)
        for k, v in zip(("depth", "tid", "gbuf"), out):
            res[f"b11/{name}/{k}"] = v

    tris = jnp.asarray(_scene_tris())
    valid = jnp.ones((tris.shape[0],), bool)
    cam = _camera("bench")
    c2, ok2 = near_clip(_project(tris, cam), valid)
    sx, sy, sz, _ = _screen(c2, 96, 96)
    res["sweep/depth"], res["sweep/tid"] = raster_screen(sx, sy, sz, ok2, 96, 96,
                                                         use_pallas=False)
    res["ids128/depth"], res["ids128/tid"] = rasterize_ids(tris, valid, cam, 128, 128)

    colors = jnp.asarray(np.random.default_rng(4).uniform(0.2, 0.9, (tris.shape[0], 3)),
                         jnp.float32)
    normals = jnp.asarray(_corner_normals(np.asarray(tris)))
    ldir = jnp.asarray(LIGHT, jnp.float32)
    lvp = light_view_proj(ldir, (0.0, 0.0, 0.0), 8.0)
    for name, (W, H, S, mode) in RENDERS.items():
        img, depth = render_scene(tris, valid, colors, cam, lvp, ldir, W=W, H=H, shadow_size=S,
                                  wireframe=mode == "wireframe",
                                  normals=normals if mode == "normals" else None)
        res[f"render/{name}/img"], res[f"render/{name}/depth"] = img, depth
    np.savez(out_path, **{k: np.asarray(v) for k, v in res.items()})


def _corner_normals(tris):
    """Per-corner unit normals: each triangle's face normal tilted toward
    its corner (smooth-looking, deterministic)."""
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    c = tris.mean(1, keepdims=True)
    v = n[:, None, :] / np.maximum(np.linalg.norm(n, axis=-1), 1e-12)[:, None, None] \
        + 0.3 * (tris - c)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("render_ref") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)], env=env,
                          stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def _cam_vp(name):
    from surtr_tpu_torch.render.camera import camera_view_proj

    eye, target, fov, aspect, zn, zf = CAMERAS[name]
    return camera_view_proj(eye, target, fov, aspect, zn, zf)


@pytest.mark.parametrize("name", list(CAMERAS))
def test_camera_matches(ref, name):
    from surtr_tpu_torch.render.camera import look_at, perspective

    eye, target, fov, aspect, zn, zf = CAMERAS[name]
    for got, key in ((look_at(eye, target), "look_at"), (perspective(fov, aspect, zn, zf),
                                                          "perspective"),
                     (_cam_vp(name), "vp")):
        np.testing.assert_allclose(got.numpy(), ref[f"cam/{name}/{key}"], atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", list(LIGHTS))
def test_light_view_proj_matches(ref, name):
    from surtr_tpu_torch.render.camera import light_view_proj, ortho

    d, c, r = LIGHTS[name]
    np.testing.assert_allclose(light_view_proj(d, c, r).numpy(), ref[f"light/{name}"],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(ortho(-3.0, 5.0, -2.0, 4.0, 0.5, 20.0).numpy(), ref["ortho"],
                               atol=1e-6, rtol=0)


def test_near_clips_match_exactly(ref):
    from surtr_tpu_torch.render.raster import _near_clip_full, _near_clip_pooled, _project

    tris, valid = (torch.as_tensor(a) for a in _near_cloud())
    clip = _project(tris, _cam_vp("near"))
    np.testing.assert_array_equal(clip.numpy(), ref["nc/clip"])
    c2, a2, v2 = _near_clip_full(clip, valid, tris)
    np.testing.assert_array_equal(c2.numpy(), ref["nc/full_clip"])
    np.testing.assert_array_equal(a2.numpy(), ref["nc/full_aux"])
    np.testing.assert_array_equal(v2.numpy(), ref["nc/full_ok"])
    pc, pok, src = _near_clip_pooled(clip, valid)
    np.testing.assert_array_equal(pc.numpy(), ref["nc/pool_clip"])
    np.testing.assert_array_equal(pok.numpy(), ref["nc/pool_ok"])
    np.testing.assert_array_equal(src.numpy(), ref["nc/pool_src"])
    # The case exercises one- and two-inside triangles and a full pool.
    w_in = (clip[..., 3] > 1e-4).sum(-1)
    two = (w_in == 2) & valid
    assert ((w_in == 1) & valid).any() and int(two.sum()) > 300 and int(pok[2400:].sum()) == 300


@pytest.mark.parametrize("name", list(RASTER_CASES))
def test_b11_plain_matches_pallas_interpret(ref, name):
    # Kernel B11's plain version (what the CPU runs; chip_smoke.py holds the
    # kernel against it bitwise on the card) equals rasterize_ids_pallas in
    # interpret mode: depth, ids and the G-buffer.
    from surtr_tpu_torch.render.raster_cuda import rasterize_ids_tiled

    gbuf = RASTER_CASES[name][2]
    sx, sy, sz, ok, attr = _raster_inputs(name)
    t = torch.as_tensor
    out = rasterize_ids_tiled(t(sx), t(sy), t(sz), t(ok), RW, RH,
                              attr_tab=None if attr is None else t(attr))
    assert len(out) == (3 if gbuf else 2)
    for k, v in zip(("depth", "tid", "gbuf"), out):
        np.testing.assert_array_equal(v.numpy(), ref[f"b11/{name}/{k}"], err_msg=k)
    tid = out[1].numpy()
    if name == "none_valid":
        assert (tid == -1).all()
    else:
        assert (tid >= 0).all() and (tid == 0).any() and (tid == 1).any()
        assert not (tid == 2).any() and not (tid == 3).any()


def test_sweep_matches_exactly(ref):
    from surtr_tpu_torch.render.raster import _project, _screen, near_clip, raster_screen

    tris = torch.as_tensor(_scene_tris())
    c2, ok2 = near_clip(_project(tris, _cam_vp("bench")), torch.ones(tris.shape[0],
                                                                      dtype=torch.bool))
    sx, sy, sz, _ = _screen(c2, 96, 96)
    depth, tid = raster_screen(sx, sy, sz, ok2, 96, 96)
    np.testing.assert_array_equal(depth.numpy(), ref["sweep/depth"])
    np.testing.assert_array_equal(tid.numpy(), ref["sweep/tid"])


def test_tiled_route_matches_jnp_rasterize_ids(ref):
    # 128²: the port takes the tiled raster (B11's plain version), the JAX
    # package on the CPU its sweep. Depth is equal; ids agree but for ties.
    from surtr_tpu_torch.render.raster import rasterize_ids

    tris = torch.as_tensor(_scene_tris())
    depth, tid = rasterize_ids(tris, torch.ones(tris.shape[0], dtype=torch.bool),
                               _cam_vp("bench"), 128, 128)
    np.testing.assert_array_equal(depth.numpy(), ref["ids128/depth"])
    assert (tid.numpy() == ref["ids128/tid"]).mean() >= 0.999


@pytest.mark.parametrize("name", list(RENDERS))
def test_render_scene_matches(ref, name):
    from surtr_tpu_torch.render.camera import light_view_proj
    from surtr_tpu_torch.render.raster import render_scene

    W, H, S, mode = RENDERS[name]
    tris_np = _scene_tris()
    tris = torch.as_tensor(tris_np)
    colors = torch.as_tensor(np.random.default_rng(4).uniform(0.2, 0.9, (tris.shape[0], 3)),
                             dtype=torch.float32)
    img, depth = render_scene(
        tris, torch.ones(tris.shape[0], dtype=torch.bool), colors, _cam_vp("bench"),
        light_view_proj(LIGHT, (0.0, 0.0, 0.0), 8.0), LIGHT, W=W, H=H, shadow_size=S,
        wireframe=mode == "wireframe",
        normals=torch.as_tensor(_corner_normals(tris_np)) if mode == "normals" else None)
    assert img.shape == (H, W, 3)
    np.testing.assert_array_equal(depth.numpy(), ref[f"render/{name}/depth"])
    close = (np.abs(img.numpy() - ref[f"render/{name}/img"]) <= IMG_ATOL).all(-1)
    assert close.mean() >= IMG_SHARE, close.mean()
    # Lit and shadowed geometry and background all appear.
    assert (depth.numpy() < 1).mean() > 0.2 and (depth.numpy() > 1).any()


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
