"""The port's ``do_fracture`` and contact split on the CPU (every kernel's
plain version) against the JAX package's.

The events: ``tests/test_fracture.py``'s configuration with
``exact_caps=False`` and a 64-cell partial pattern (A×C = 512 > JPOOL =
256, so the pre-fold job cull runs; JCAP × Tp = 16,384), three events from
one prepared cube: partial at (1.5, 1.5, 1.5), general at the origin (with
A = 16, so that every overflow counter reads 0), partial with
``mesh_pair_pool=True`` (the pooled job mesh clip) and partial with
``refitting_point_limit=8`` (the ICH refit). The JAX
reference runs compiled in a child process with ``--xla_cpu_max_isa=AVX``
(no FMA contraction, as in the port; see ``test_torch_prepare.py``), and
the port starts from the JAX package's own prepared pieces and context, so
both sides fold the same bits.

Run as a script (``python tests/test_torch_fracture.py OUT.npz``) it writes
the JAX reference.
"""

import dataclasses
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import bounded_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = dict(
    initial_decompose_cell_cnt=16, max_pieces=128, max_faces=32, max_face_verts=16,
    max_piece_tris=128, max_active_pieces=8, partial_pattern_cell_cnt=64,
    general_pattern_cell_cnt=32, voronoi_neighbors=31, exact_caps=False,
)
EVENTS = {
    "partial": ((1.5, 1.5, 1.5), True, {}),
    # All 16 pieces are active in general mode: A = 16 keeps every overflow 0.
    "general": ((0.0, 0.0, 0.0), False, {"max_active_pieces": 16}),
    "pooled": ((1.5, 1.5, 1.5), True, {"mesh_pair_pool": True}),
    # The ICH refit of the impact's pieces (refitting_point_limit 8 > 4).
    "refit8": ((1.5, 1.5, 1.5), True, {"refitting_point_limit": 8}),
}
OVERFLOWS = ("active_overflow", "job_overflow", "piece_overflow", "split_face_overflow")
COUNTS = ("new_pieces", "active_pieces", "merged_out", "num_groups", "mesh_tris_dropped")


def _flatten(prefix, obj, out):
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _flatten(f"{prefix}/{f.name}", getattr(obj, f.name), out)
    else:
        out[prefix] = np.asarray(obj)


def _unflatten(ref, prefix):
    """The saved container under ``prefix`` as nested namespaces of arrays."""
    tree = {}
    for k, v in ref.items():
        if k.startswith(prefix + "/"):
            node = tree
            *path, leaf = k[len(prefix) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v

    def ns(d):
        return types.SimpleNamespace(**{k: ns(v) if isinstance(v, dict) else v
                                        for k, v in d.items()})
    return ns(tree)


def _jax_reference(out_path):
    """Child-process side: prepare the cube and run the events."""
    from surtr_tpu.config import FractureConfig
    from surtr_tpu.fracture.pipeline import do_fracture, prepare_fracture
    from surtr_tpu.io.models import get_model, sphere_point_cloud

    cfg = FractureConfig(**CFG)
    v, f = get_model("cube")
    pieces, ctx, _ = prepare_fracture(
        jnp.asarray(v), jnp.ones(len(v), bool), jnp.asarray(v[f]), jnp.ones(len(f), bool),
        jnp.asarray(sphere_point_cloud()), jax.random.PRNGKey(cfg.seed), cfg)
    res = {}
    _flatten("in/pieces", pieces, res)
    _flatten("in/ctx", ctx, res)
    for name, (impact, partial, changes) in EVENTS.items():
        out, met = do_fracture(pieces, ctx, jnp.asarray(impact, jnp.float32), 0,
                               dataclasses.replace(cfg, **changes), partial=partial)
        _flatten(f"{name}/out", out, res)
        for k, val in met.items():
            res[f"{name}/m/{k}"] = np.asarray(val)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("fracture_ref") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)], env=env,
                          stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def _port_inputs(ref):
    from surtr_tpu_torch import convert

    return (convert.pieces_from(_unflatten(ref, "in/pieces")),
            convert.context_from(_unflatten(ref, "in/ctx")))


@pytest.fixture(scope="module")
def port_runs(jax_ref):
    from surtr_tpu_torch.config import FractureConfig
    from surtr_tpu_torch.fracture import pipeline

    pieces, ctx = _port_inputs(jax_ref)
    runs, pooled_args = {}, []
    clip = pipeline._pooled_job_mesh_clip

    def recording(*a, **kw):
        pooled_args.append(a)
        return clip(*a, **kw)

    pipeline._pooled_job_mesh_clip = recording
    try:
        for name, (impact, partial, changes) in EVENTS.items():
            cfg = dataclasses.replace(FractureConfig(**CFG), **changes)
            runs[name] = pipeline.do_fracture(pieces, ctx, torch.tensor(impact), 0, cfg,
                                              partial=partial)
    finally:
        pipeline._pooled_job_mesh_clip = clip
    runs["pooled_args"] = pooled_args
    return runs


@pytest.mark.parametrize("name", list(EVENTS))
def test_do_fracture_metrics_match(jax_ref, port_runs, name):
    _, met = port_runs[name]
    for k in OVERFLOWS:
        assert int(met[k]) == 0 and int(jax_ref[f"{name}/m/{k}"]) == 0, k
    for k in COUNTS:
        assert int(met[k]) == int(jax_ref[f"{name}/m/{k}"]), k
    np.testing.assert_allclose(float(met["total_volume"]),
                               float(jax_ref[f"{name}/m/total_volume"]), rtol=1e-5)
    assert float(met["total_volume"]) == pytest.approx(27.0, rel=1e-3)
    assert int(met["new_pieces"]) > 0


@pytest.mark.parametrize("name", list(EVENTS))
def test_do_fracture_pieces_match(jax_ref, port_runs, name):
    out, _ = port_runs[name]
    r = lambda k: jax_ref[f"{name}/out/{k}"]  # noqa: E731
    np.testing.assert_array_equal(out.valid.numpy(), r("valid"))
    np.testing.assert_array_equal(out.group.numpy(), r("group"))
    np.testing.assert_array_equal(out.tag.numpy(), r("tag"))
    np.testing.assert_array_equal(out.convex.n_verts.numpy(), r("convex/n_verts"))
    sm = out.convex.slot_mask().numpy()[..., None]
    np.testing.assert_allclose(np.where(sm, out.convex.face_verts.numpy(), 0),
                               np.where(sm, r("convex/face_verts"), 0), atol=1e-5)
    fm = out.convex.face_mask().numpy()[..., None]
    np.testing.assert_allclose(np.where(fm, out.convex.planes.numpy(), 0),
                               np.where(fm, r("convex/planes"), 0), atol=1e-5)
    np.testing.assert_array_equal(out.mesh_valid.numpy(), r("mesh_valid"))
    mv = out.mesh_valid.numpy()[..., None, None]
    np.testing.assert_allclose(np.where(mv, out.mesh.numpy(), 0), np.where(mv, r("mesh"), 0),
                               atol=1e-5)


def test_pooled_job_clip_card_branch_matches_cpu_branch(port_runs):
    # The branch the card takes (bounding-sphere cull, stable pack into
    # 3/8 of the pool with the sentinel job, plain B10 with its per-block
    # context) against the CPU branch (no pack, clip_polys_by_rows with
    # per-job context), on the pooled event's own inputs.
    from surtr_tpu_torch.fracture.pipeline import _pooled_job_mesh_clip

    (args,) = port_runs["pooled_args"]
    jmesh, jmmask = args[0], args[1]
    assert jmmask.numel() >= 8192 and int(jmmask.sum()) > 0
    card = _pooled_job_mesh_clip(*args, on_card=True)
    cpu = _pooled_job_mesh_clip(*args, on_card=False)
    assert int(card[2]) == int(cpu[2]) == 0
    np.testing.assert_array_equal(card[1].numpy(), cpu[1].numpy())
    m = cpu[1].numpy()[..., None, None]
    np.testing.assert_array_equal(np.where(m, card[0].numpy(), 0), np.where(m, cpu[0].numpy(), 0))
    assert int(cpu[1].sum()) > 0


# ---------------------------------------------------------------------------
# Units against the JAX package, in process.
# ---------------------------------------------------------------------------

def _jpoly_stack(*polys):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *polys)


def _port_poly(jp):
    from surtr_tpu_torch import convert

    return convert.poly_from(jp)


def test_convex_out_of_sphere_matches():
    from surtr_tpu.fracture.pipeline import convex_out_of_sphere as j_out
    from surtr_tpu.io.models import sphere_point_cloud
    from surtr_tpu.types import scale_poly, translate_poly, unit_cube
    from surtr_tpu_torch.fracture.pipeline import convex_out_of_sphere

    cloud = np.asarray(sphere_point_cloud())
    cases = [
        # A unit cube at the center and one far away (test_fracture.py:106-124).
        (_jpoly_stack(unit_cube(), translate_poly(unit_cube(), jnp.array([10.0, 0, 0]))),
         cloud * 1.0, np.zeros(3, np.float32), 1.0),
        # A big convex that holds the whole sphere but no vertex of it.
        (jax.tree_util.tree_map(lambda a: a[None], scale_poly(unit_cube(), 20.0)),
         cloud, np.zeros(3, np.float32), 1.0),
        # Cubes scattered around an impact at radius 1.3, one emptied.
        (_jpoly_stack(*[translate_poly(unit_cube(), jnp.asarray(o, jnp.float32))
                        for o in np.random.RandomState(5).uniform(-2.5, 2.5, (12, 3))]),
         cloud * 1.3 + 0.2, np.full(3, 0.2, np.float32), 1.3),
    ]
    for jp, cl, center, radius in cases:
        want = np.asarray(j_out(jp, jnp.asarray(cl), jnp.asarray(center), radius))
        got = convex_out_of_sphere(_port_poly(jp), torch.as_tensor(cl), torch.as_tensor(center),
                                   radius).numpy()
        np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def _contact_cases():
    from surtr_tpu.types import translate_poly, unit_cube

    at = lambda *o: translate_poly(unit_cube(), jnp.asarray(o, jnp.float32))  # noqa: E731
    return {
        # Two touching cubes stay one group; a far third splits off
        # (test_fracture.py:127-148).
        "separation": [at(0, 0, 0), at(1, 0, 0), at(5, 0, 0)],
        # Coplanar opposite faces laterally offset: spheres overlap, the
        # polygons do not (test_fracture.py:200-244), and the touching control.
        "offset": [at(0, 0, 0), at(1, 1.2, 0)],
        "touching": [at(0, 0, 0), at(1, 0.3, 0)],
        # A 3x3 slab of cubes in two compounds with one gap.
        "slab": [at(x, y, 0) for x in range(3) for y in range(3) if (x, y) != (1, 1)],
    }


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("case", ["separation", "offset", "touching", "slab"])
def test_split_groups_by_contact_matches(case, exact):
    from surtr_tpu.fracture.pipeline import split_groups_by_contact as j_split
    from surtr_tpu.fracture.types import PieceSet as JPieceSet
    from surtr_tpu_torch.fracture.pipeline import split_groups_by_contact
    from surtr_tpu_torch.fracture.types import PieceSet

    polys = _contact_cases()[case]
    P = len(polys)
    group = np.zeros(P, np.int32)
    if case == "slab":
        group[P // 2:] = 3
    valid = np.ones(P, bool)
    jp = JPieceSet(_jpoly_stack(*polys), jnp.zeros((P, 4, 3, 3)), jnp.zeros((P, 4), bool),
                   jnp.asarray(valid), jnp.asarray(group), jnp.full((P,), -1, jnp.int32))
    want, wover = j_split(jp, eps=1e-3, exact=exact)
    pp = PieceSet(_port_poly(jp.convex), torch.zeros((P, 4, 3, 3)),
                  torch.zeros((P, 4), dtype=torch.bool), torch.as_tensor(valid),
                  torch.as_tensor(group), torch.full((P,), -1, dtype=torch.int32))
    got, gover = split_groups_by_contact(pp, eps=1e-3, exact=exact)
    np.testing.assert_array_equal(got.group.numpy(), np.asarray(want.group))
    assert int(gover) == int(wover) == 0
    assert int(got.num_groups()) == int(want.num_groups())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adjacency_components_and_renumber_match(seed):
    from surtr_tpu.fracture.pipeline import _dense_renumber as j_renumber
    from surtr_tpu.ops.labels import adjacency_components as j_components
    from surtr_tpu_torch.fracture.pipeline import _dense_renumber
    from surtr_tpu_torch.ops.labels import adjacency_components

    rng = np.random.default_rng(seed)
    N = [37, 64, 100][seed]
    adj = rng.uniform(size=(N, N)) < 0.6 / N
    valid = rng.uniform(size=N) > 0.15
    want = np.asarray(j_components(jnp.asarray(adj), jnp.asarray(valid)))
    got = adjacency_components(torch.as_tensor(adj), torch.as_tensor(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(got[valid].tolist())) > 1

    group = rng.integers(0, 3 * N, N).astype(np.int32)
    want = np.asarray(j_renumber(jnp.asarray(group), jnp.asarray(valid)))
    got = _dense_renumber(torch.as_tensor(group), torch.as_tensor(valid)).numpy()
    np.testing.assert_array_equal(got, want)


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
