"""The port's configuration mirrors the JAX package's field for field, and
its containers round-trip through ``surtr_tpu_torch.convert``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import surtr_tpu.config as jcfg
import surtr_tpu_torch.config as tcfg
from surtr_tpu.fracture.types import FractureContext as JContext
from surtr_tpu.fracture.types import empty_piece_set as j_empty_piece_set
from surtr_tpu.types import unit_cube as j_unit_cube
from surtr_tpu_torch import convert
from surtr_tpu_torch.fracture.types import empty_piece_set
from surtr_tpu_torch.types import unit_cube
from torch_threads import bounded_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize(
    "name", ["FractureConfig", "PhysicsConfig", "RenderConfig", "SceneConfig"]
)
def test_config_mirrors_fields(name):
    jf = dataclasses.fields(getattr(jcfg, name))
    tf = dataclasses.fields(getattr(tcfg, name))
    assert [f.name for f in jf] == [f.name for f in tf]
    assert [str(f.type) for f in jf] == [str(f.type) for f in tf]
    for a, b in zip(jf, tf):
        if a.default_factory is not dataclasses.MISSING:
            assert dataclasses.asdict(a.default_factory()) == dataclasses.asdict(b.default_factory())
        else:
            assert a.default == b.default, a.name
    assert getattr(tcfg, name).__dataclass_params__.frozen


def test_fracture_config_round_trip():
    j = jcfg.FractureConfig(initial_decompose_cell_cnt=1024, max_faces=26, exact_caps=False)
    t = convert.config_from(j)
    assert convert.config_to_dict(t) == dataclasses.asdict(j)
    assert jcfg.FractureConfig(**convert.config_to_dict(t)) == j


def test_convex_poly_round_trip():
    # unit_cube is built the same way on both sides: bitwise equal.
    jc = j_unit_cube(F=12, S=8)
    tc = convert.poly_from(jc)
    np.testing.assert_array_equal(convert.to_numpy(unit_cube(F=12, S=8).face_verts),
                                  np.asarray(jc.face_verts))
    back = convert.poly_to_numpy(tc)
    for k in ("face_verts", "n_verts", "planes"):
        np.testing.assert_array_equal(back[k], np.asarray(getattr(jc, k)))
    assert tc.n_verts.dtype == torch.int32
    assert np.array_equal(convert.to_numpy(tc.slot_mask()), np.asarray(jc.slot_mask()))
    assert np.array_equal(convert.to_numpy(tc.is_empty()), np.asarray(jc.is_empty()))


def test_piece_set_and_context_round_trip():
    jp = j_empty_piece_set(4, 6, 8, 5)
    tp = convert.pieces_from(jp)
    ref = empty_piece_set(4, 6, 8, 5)
    for f in ("mesh", "mesh_valid", "valid", "group", "tag"):
        assert torch.equal(getattr(tp, f), getattr(ref, f)), f
    back = convert.pieces_to_numpy(tp)
    np.testing.assert_array_equal(back["group"], np.asarray(jp.group))
    np.testing.assert_array_equal(back["convex"]["n_verts"], np.asarray(jp.convex.n_verts))

    cube = j_unit_cube(F=8, S=6)
    pat = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a[None], (2,) + a.shape), cube)
    jctx = JContext(
        bb_center=jnp.zeros(3), bb_min=-jnp.ones(3), bb_max=jnp.ones(3),
        max_axis_scale=jnp.float32(2.0), partial_pattern=pat, general_pattern=pat,
        sphere_cloud=jnp.ones((42, 3)),
    )
    tctx = convert.context_from(jctx)
    back = convert.context_to_numpy(tctx)
    np.testing.assert_array_equal(back["bb_min"], np.asarray(jctx.bb_min))
    np.testing.assert_array_equal(back["general_pattern"]["planes"],
                                  np.asarray(jctx.general_pattern.planes))
    assert float(tctx.max_axis_scale) == 2.0
