"""The port's reference model registry and OBJ parser against the JAX
package's (``surtr_tpu/io/models.py``, ``surtr_tpu/io/obj.py``): the same
registry, the same bits from a mounted resource tree, procedural names
first, ``KeyError`` for a name that is neither procedural nor mounted, the
10,000-triangle torus's OBJ text parsed to the same bits, and the CLI on a
registry name.

Both packages' ``REFERENCE_ROOT`` point at a small tree written here. The
JAX package's ``load_obj`` tries its native C++ parser first, which matches
its Python parser only within 1e-6 (tests/test_native.py); the port has
the Python parser alone, so the JAX side is held to that parser here.
"""

import contextlib
import io
import json
import sys

import numpy as np
import pytest

import surtr_tpu.__main__ as j_main
import surtr_tpu.io.models as j_models
import surtr_tpu.io.obj as j_obj
import surtr_tpu_torch.__main__ as t_main
import surtr_tpu_torch.io.models as t_models
import surtr_tpu_torch.io.obj as t_obj
from surtr_tpu_torch import workload

MOUNTED = ("cube", "shuttle", "pumpkin")

# A quad cube of half-extent 0.7 about (0.1, -0.2, 0.3), faces outward:
# v/vt/vn, v//vn and v/vt tokens, positive and negative indices.
_CORNERS = [(x, y, z) for x in (-0.7, 0.7) for y in (-0.7, 0.7) for z in (-0.7, 0.7)]
_QUADS = [(4, 6, 7, 5), (0, 1, 3, 2), (2, 3, 7, 6), (0, 4, 5, 1), (1, 5, 7, 3), (0, 2, 6, 4)]


def _quad_cube_obj() -> str:
    lines = ["# quad cube", "o cube"]
    lines += [f"v {x + 0.1:.6f} {y - 0.2:.6f} {z + 0.3:.6f}" for x, y, z in _CORNERS]
    lines += ["vt 0.0 0.0", "vt 1.0 0.0", "vt 1.0 1.0", "vt 0.0 1.0"]
    lines += ["vn 1 0 0", "vn -1 0 0", "vn 0 1 0", "vn 0 -1 0", "vn 0 0 1", "vn 0 0 -1"]
    for n, q in enumerate(_QUADS):
        if n % 3 == 0:
            toks = [f"{i + 1}/{k + 1}/{n + 1}" for k, i in enumerate(q)]
        elif n % 3 == 1:
            toks = [f"{i - 8}//{n + 1}" for i in q]
        else:
            toks = [f"{i - 8}/{k + 1}" for k, i in enumerate(q)]
        lines.append("f " + " ".join(toks))
    return "\n".join(lines) + "\n"


@pytest.fixture
def mounted(tmp_path, monkeypatch):
    """A resource tree holding the quad cube under three registry paths,
    with both packages' REFERENCE_ROOT on it and the JAX package's native
    parser out of reach."""
    for name in MOUNTED:
        path = tmp_path / t_models.REFERENCE_MODELS[name][0]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(_quad_cube_obj())
    monkeypatch.setattr(t_models, "REFERENCE_ROOT", str(tmp_path))
    monkeypatch.setattr(j_models, "REFERENCE_ROOT", str(tmp_path))
    monkeypatch.setitem(sys.modules, "surtr_tpu.native", None)
    return tmp_path


def _same(a, b):
    (va, fa), (vb, fb) = a, b
    assert va.dtype == vb.dtype == np.float32 and fa.dtype == fb.dtype == np.int32
    np.testing.assert_array_equal(va.view(np.uint32), vb.view(np.uint32))
    np.testing.assert_array_equal(fa, fb)


def test_registry_is_the_jax_packages():
    assert t_models.REFERENCE_MODELS == j_models.REFERENCE_MODELS


@pytest.mark.parametrize("name", MOUNTED)
def test_load_reference_model_matches_jax(mounted, name):
    got = t_models.load_reference_model(name)
    _same(got, j_models.load_reference_model(name))
    v, f = got
    assert v.shape == (8, 3) and f.shape == (12, 3)
    scale = np.asarray(t_models.REFERENCE_MODELS[name][1], np.float64)
    # The cube's volume at its scale, outward (mirrored and re-wound).
    v64 = v.astype(np.float64)
    vol = np.einsum("ij,ij->i", v64[f[:, 0]], np.cross(v64[f[:, 1]], v64[f[:, 2]])).sum() / 6
    np.testing.assert_allclose(vol, 1.4 ** 3 * np.prod(scale), rtol=1e-5)


@pytest.mark.parametrize("name", ["shuttle", "pumpkin", "cube", "sphere", "torus", "blob"])
def test_get_model_matches_jax(mounted, name):
    got = t_models.get_model(name)
    _same(got, j_models.get_model(name))
    if name in ("cube", "sphere"):
        # Procedural names win over a mounted registry OBJ of the same name.
        _same(got, {"cube": t_models.box((3.0, 3.0, 3.0)),
                    "sphere": t_models.icosphere(2, 1.5)}[name])
        assert not np.array_equal(got[0], t_models.load_reference_model("cube")[0])


@pytest.mark.parametrize("name", ["bunny", "cessna", "ground", "no-such-model"])
def test_unmounted_or_unknown_model_raises_in_both(mounted, name):
    with pytest.raises(KeyError) as mine:
        t_models.get_model(name)
    with pytest.raises(KeyError) as theirs:
        j_models.get_model(name)
    assert str(mine.value) == str(theirs.value)


def test_parse_obj_of_the_model_scale_torus_matches_jax():
    text = workload.model_scale_obj_text()
    got = t_obj.parse_obj(text)
    _same(got, j_obj.parse_obj(text))
    assert got[0].shape == (5000, 3) and got[1].shape == (10000, 3)
    _same(workload.model_scale_mesh(), got)


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_runs_a_mounted_reference_model(mounted):
    res = _cli(t_main.main, ["--device", "cpu", "--model", "shuttle", "--preset", "tiny",
                             "--steps", "2"])
    assert res["model"] == "shuttle" and res["steps"] == 2 and res["pieces"] > 0
    assert abs(res["volume"] - 1.4 ** 3) < 0.01


def test_cli_missing_reference_model_fails_as_the_jax_cli(tmp_path, monkeypatch):
    monkeypatch.setattr(t_models, "REFERENCE_ROOT", str(tmp_path))
    monkeypatch.setattr(j_models, "REFERENCE_ROOT", str(tmp_path))
    argv = ["--model", "pumpkin", "--steps", "1"]
    with pytest.raises(KeyError) as mine:
        t_main.main(["--device", "cpu"] + argv)
    with pytest.raises(KeyError) as theirs:
        j_main.main(argv)
    assert str(mine.value) == str(theirs.value) == "\"unknown model 'pumpkin'\""
