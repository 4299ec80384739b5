"""The port's parity grid and exact caps on the CPU against the JAX
package's: ``build_parity_grid`` / ``parity_grid_inside`` bit for bit, and
``cap_fans_batch`` on identical inputs, captured from the port's own
``prepare_fracture`` of a small blob (32 cells: the ray-parity probes) and
a small torus (64 cells and 576 triangles: the grid probes).

The JAX side runs compiled in a child process with ``--xla_cpu_max_isa=AVX``
(no FMA contraction, as in the port; see ``test_torch_prepare.py``), on the
inputs the parent writes. Run as a script (``python tests/test_torch_caps.py
IN.npz OUT.npz``) it is that child.

Tolerances: the grids, the keep decisions (``cap_ok``, ``pool_m``) and the
drop counts exactly; cap rows and pool points within 1e-5 × the model's
scale (the loop centres and fan origins are float64 sums rounded once in
the port, float32 sums in XLA's order in the JAX package).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_threads import bounded_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASE = dict(max_faces=26, max_face_verts=16, voronoi_prefix=8, max_piece_tris=128,
            voronoi_neighbors=31, partial_pattern_cell_cnt=8, general_pattern_cell_cnt=8)
CAPS = {
    "blob32": ("blob", dict(BASE, initial_decompose_cell_cnt=32, max_pieces=32)),
    "torus64": ("torus", dict(BASE, initial_decompose_cell_cnt=64, max_pieces=64)),
}
GRIDS = [("torus", 64), ("torus", 48), ("cube", 64), ("cube", 48)]
CAP_OUT = ("cap_rows", "cap_ok", "pool_v", "pool_m", "dropped")


def _corners(model):
    from surtr_tpu_torch.io.models import get_model

    v, f = get_model(model)
    return v[f].astype(np.float32)


def _query_points(model, n=512, seed=0):
    """``n`` seeded points over the model's box grown by 20% a side."""
    c = _corners(model).reshape(-1, 3)
    lo, hi = c.min(0), c.max(0)
    ext = hi - lo
    rng = np.random.RandomState(seed)
    return ((lo - 0.2 * ext) + rng.rand(n, 3) * (1.4 * ext)).astype(np.float32)


def _jax_reference(in_path, out_path):
    """Child-process side: the JAX grids and caps on the parent's inputs."""
    import jax
    import jax.numpy as jnp

    from surtr_tpu.config import FractureConfig
    from surtr_tpu.ops.caps import cap_fans_batch
    from surtr_tpu.ops.mesh_clip import build_parity_grid, parity_grid_inside
    from surtr_tpu.types import ConvexPoly

    inp = dict(np.load(in_path))
    res = {}
    for model, r in GRIDS:
        c = jnp.asarray(_corners(model))
        g = jax.jit(lambda a, m, r=r: build_parity_grid(a, m, res=r))(
            c, jnp.ones(c.shape[0], bool))
        for k in ("lo", "ext", "inside"):
            res[f"grid/{model}{r}/{k}"] = np.asarray(g[k])
        res[f"grid/{model}{r}/query"] = np.asarray(
            parity_grid_inside(g, jnp.asarray(_query_points(model))))
    for name, (model, kw) in CAPS.items():
        a = lambda k: jnp.asarray(inp[f"{name}/{k}"])  # noqa: E731
        conv = ConvexPoly(a("face_verts"), a("n_verts"), a("planes"))
        N = conv.n_verts.shape[0]
        st = jnp.broadcast_to(a("solid_t")[None], (N,) + inp[f"{name}/solid_t"].shape)
        sm = jnp.ones(st.shape[:2], bool)
        grid = None
        if f"{name}/grid_res" in inp:
            grid = build_parity_grid(a("solid_t"), sm[0], res=int(inp[f"{name}/grid_res"]))
        out = jax.jit(lambda cv, mt, mm, cp, cm, s, m, mas: cap_fans_batch(
            cv, mt, mm, cp, cm, s, m, mas, FractureConfig(**kw), solid_grid=grid))(
            conv, a("mtris"), a("mmask"), a("cut_planes"), a("cut_mask"), st, sm, a("mas"))
        for k, v in zip(CAP_OUT, out):
            res[f"{name}/{k}"] = np.asarray(v)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's captured cap_fans_batch calls and outputs, and the JAX
    reference on the same inputs."""
    from surtr_tpu_torch import workload
    from surtr_tpu_torch.config import FractureConfig
    from surtr_tpu_torch.fracture import pipeline

    tmp = tmp_path_factory.mktemp("caps_ref")
    inp, port = {}, {}
    orig = pipeline.cap_fans_batch
    for name, (model, kw) in CAPS.items():
        calls = []

        def rec(*a, **k):
            out = orig(*a, **k)
            calls.append((a, k, out))
            return out

        pipeline.cap_fans_batch = rec
        try:
            workload.run_prepare("cpu", FractureConfig(**kw), model=model)
        finally:
            pipeline.cap_fans_batch = orig
        (a, k, out), = calls
        conv, mtris, mmask, cut_planes, cut_mask, solid_t, _, mas, _ = a
        for f, t in (("face_verts", conv.face_verts), ("n_verts", conv.n_verts),
                     ("planes", conv.planes), ("mtris", mtris), ("mmask", mmask),
                     ("cut_planes", cut_planes), ("cut_mask", cut_mask),
                     ("solid_t", solid_t[0]), ("mas", mas)):
            inp[f"{name}/{f}"] = t.numpy()
        if k.get("solid_grid") is not None:
            inp[f"{name}/grid_res"] = np.asarray(k["solid_grid"]["res"])
        port[name] = dict(zip(CAP_OUT, out))
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(tmp / "in.npz"),
                           str(tmp / "out.npz")], env=env, stdout=subprocess.DEVNULL,
                          stderr=subprocess.PIPE, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return inp, port, dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("model,res", GRIDS)
def test_parity_grid_matches_jax(runs, model, res):
    from surtr_tpu_torch.ops.mesh_clip import build_parity_grid, parity_grid_inside

    ref = runs[2]
    c = torch.as_tensor(_corners(model))
    g = build_parity_grid(c, torch.ones(c.shape[0], dtype=torch.bool), res=res)
    for k in ("lo", "ext", "inside"):
        np.testing.assert_array_equal(g[k].numpy(), ref[f"grid/{model}{res}/{k}"], err_msg=k)
    assert int(g["inside"].sum()) > 0
    got = parity_grid_inside(g, torch.as_tensor(_query_points(model)))
    np.testing.assert_array_equal(got.numpy(), ref[f"grid/{model}{res}/query"])


@pytest.mark.parametrize("name", list(CAPS))
def test_cap_fans_batch_matches_jax(runs, name):
    inp, port, ref = runs
    got = port[name]
    r = lambda k: ref[f"{name}/{k}"]  # noqa: E731
    mas = float(inp[f"{name}/mas"])
    assert int(got["dropped"]) == int(r("dropped"))
    np.testing.assert_array_equal(got["cap_ok"].numpy(), r("cap_ok"))
    np.testing.assert_array_equal(got["pool_m"].numpy(), r("pool_m"))
    ok = got["cap_ok"].numpy()
    assert ok.sum() > 0 and got["pool_m"].numpy().sum() > 0
    np.testing.assert_allclose(got["cap_rows"].numpy()[ok], r("cap_rows")[ok], rtol=0,
                               atol=1e-5 * mas)
    pm = got["pool_m"].numpy()
    np.testing.assert_allclose(got["pool_v"].numpy()[pm], r("pool_v")[pm], rtol=0,
                               atol=1e-5 * mas)


def test_cap_inputs_take_both_probe_routes(runs):
    inp = runs[0]
    assert "blob32/grid_res" not in inp            # ray parity against each solid
    assert int(inp["torus64/grid_res"]) == 64      # the parity grid


@pytest.mark.parametrize("model", ["cube", "sphere"])
def test_parity_grid_matches_winding(model):
    """The mirror of ``tests/test_parity_grid.py``'s test: the grid agrees
    with the exact winding-number test wherever that is constant over a
    one-cell ball around the point."""
    from surtr_tpu_torch.ops.mesh_clip import (build_parity_grid, parity_grid_inside,
                                               winding_inside)

    corners = torch.as_tensor(_corners(model))
    tmask = torch.ones(corners.shape[0], dtype=torch.bool)
    grid = build_parity_grid(corners, tmask, res=48)
    c = _corners(model).reshape(-1, 3)
    ext = c.max(0) - c.min(0)
    pts = torch.as_tensor(_query_points(model))
    got = parity_grid_inside(grid, pts).numpy()
    want = winding_inside(pts, corners, tmask).numpy()
    cell = float(np.max(ext) / 48)
    offs = cell * np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    nb = np.stack([winding_inside(pts + torch.as_tensor(o), corners, tmask).numpy()
                   for o in offs], axis=1)
    far = (nb == want[:, None]).all(axis=1)
    assert far.sum() > 100
    np.testing.assert_array_equal(got[far], want[far])


def test_parity_grid_outside_bbox_is_outside():
    from surtr_tpu_torch.ops.mesh_clip import build_parity_grid, parity_grid_inside

    corners = torch.as_tensor(_corners("cube"))
    grid = build_parity_grid(corners, torch.ones(corners.shape[0], dtype=torch.bool), res=16)
    far = torch.tensor([[50.0, 0.0, 0.0], [0.0, -50.0, 0.0]])
    assert not bool(parity_grid_inside(grid, far).any())


if __name__ == "__main__":
    _jax_reference(sys.argv[1], sys.argv[2])
