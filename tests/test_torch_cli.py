"""The port's CLI (``python -m surtr_tpu_torch``) on the CPU against the JAX
package's (tests/test_cli.py): the same impact and camera parsing, the
tiny end-to-end run with ``--device cpu`` (pieces, bodies, volume 27 ±
0.1, frames, snapshot, trajectory), and the snapshot read by the JAX
package's own ``load_scene``; a reference model that is not mounted fails
with ``get_model``'s ``KeyError``, as in the JAX CLI.
"""

import json
import os

import numpy as np
import pytest
import torch

from surtr_tpu.__main__ import camera_eye as j_camera_eye
from surtr_tpu.__main__ import parse_impact as j_parse_impact
from surtr_tpu_torch.__main__ import camera_eye, main, parse_impact
from torch_threads import bounded_threads  # noqa: F401 (autouse)

IMPACTS = ["0,4.5,-10:0,0,1@60", "1,2,3:4,5,6", "-1.5,0,2:0,-1,0@7"]
CAMERAS = [("fly:0,1,2:6,1,2", 0, 11), ("fly:0,1,2:6,1,2", 10, 11), ("orbit:10,6,2", 0, 240),
           ("orbit:10,6,2", 60, 240), ("orbit", 33, 240), ("fixed", 5, 10)]


@pytest.mark.parametrize("spec", IMPACTS)
def test_parse_impact_matches_jax(spec):
    assert parse_impact(spec) == j_parse_impact(spec)


@pytest.mark.parametrize("path,step,total", CAMERAS)
def test_camera_eye_matches_jax(path, step, total):
    np.testing.assert_array_equal(np.asarray(camera_eye(path, step, total)),
                                  np.asarray(j_camera_eye(path, step, total)))


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    paths = {"frames": tmp / "frames", "save": tmp / "state.npz", "trajectory": tmp / "traj.npz"}
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main([
            "--device", "cpu",
            "--model", "cube",
            "--preset", "tiny",
            "--steps", "12",
            "--impact", "0,10,0:0,-1,0@5",
            "--size", "64",
            "--shadow", "64",
            "--frames", str(paths["frames"]),
            "--camera", "orbit:10,6,2",
            "--save", str(paths["save"]),
            "--trajectory", str(paths["trajectory"]),
        ])
    return json.loads(buf.getvalue().strip().splitlines()[-1]), paths


def test_cli_tiny_end_to_end(tiny_run):
    res, paths = tiny_run
    assert set(res) == {"model", "steps", "pieces", "bodies", "volume", "sim_time", "wall_s"}
    assert res["model"] == "cube" and res["steps"] == 12
    # The impact fractured the initial compound.
    assert res["pieces"] > 8 and res["bodies"] > 1
    assert abs(res["volume"] - 27.0) < 0.1
    assert abs(res["sim_time"] - 0.1) < 1e-4
    assert paths["save"].exists() and paths["trajectory"].exists()
    frames = sorted(os.listdir(paths["frames"]))
    assert frames == ["f0000.ppm", "f0001.ppm"]
    with open(paths["frames"] / frames[0], "rb") as f:
        assert f.read(11) == b"P6\n64 64\n25"
    t = np.load(paths["trajectory"])["x"]
    assert t.shape[0] == 12 and t.shape[2] == 3 and np.isfinite(t).all()


def test_cli_snapshot_loads_in_the_jax_package(tiny_run):
    from surtr_tpu.checkpoint import load_scene

    from surtr_tpu_torch.checkpoint import load_scene as t_load_scene

    res, paths = tiny_run
    sc = load_scene(str(paths["save"]))
    assert sc.num_pieces() == res["pieces"]
    assert sc.num_bodies() == res["bodies"]
    assert abs(sc.total_volume() - res["volume"]) < 1e-3
    assert abs(sc.time - res["sim_time"]) < 1e-6
    mine = t_load_scene(str(paths["save"]), device="cpu")
    assert mine.num_pieces() == res["pieces"]
    np.testing.assert_array_equal(np.asarray(sc.phys.bodies.x), mine.phys.bodies.x.numpy())


def test_cli_rejects_a_reference_model(tmp_path, monkeypatch):
    # A registry name whose OBJ is not mounted fails as in the JAX CLI:
    # get_model's KeyError (tests/test_torch_models.py holds the two).
    from surtr_tpu_torch.io import models

    monkeypatch.setattr(models, "REFERENCE_ROOT", str(tmp_path))
    with pytest.raises(KeyError, match="unknown model 'pumpkin'"):
        main(["--device", "cpu", "--model", "pumpkin", "--steps", "1"])
