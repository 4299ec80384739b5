"""``correct`` at tiny sizes on the CPU, where the program runs its plain
path: true for the program as it is, false with the timed path broken
underneath (half of the pieces left out, an answer altered where it is
produced, a physics step that returns its state unchanged), and the
control (the reference in bfloat16) fails one of the numbers."""

import dataclasses

import pytest
import torch

from conftest import run_cpu


def _drop_half(pieces):
    keep = torch.arange(pieces.valid.shape[0]) % 2 == 0
    return dataclasses.replace(pieces, valid=pieces.valid & keep)


def _nudge(pieces):
    fv = pieces.convex.face_verts.clone()
    fv[0, 0, 0, 0] += 1e-3
    mesh = pieces.mesh.clone()
    mesh[0, 0, 0, 0] += 1e-3
    return dataclasses.replace(pieces, convex=dataclasses.replace(pieces.convex, face_verts=fv),
                               mesh=mesh)


@pytest.mark.parametrize("fault", [None, "drop_half", "nudge"])
def test_decompose(tiny, monkeypatch, fault):
    import surtr_tpu_torch.fracture.pipeline as pipeline

    if fault:
        orig = pipeline.prepare_fracture
        change = _drop_half if fault == "drop_half" else _nudge

        def broken(*a, **kw):
            pieces, ctx, met = orig(*a, **kw)
            return change(pieces), ctx, met

        monkeypatch.setattr(pipeline, "prepare_fracture", broken)
    rc, res, err = run_cpu(*tiny, "pumpkin_1k.decompose", seed=3_000_000_007)
    assert rc == 0, err
    assert res["correct"] is (fault is None), res["checks"]


@pytest.mark.parametrize("fault", [None, "drop_half", "nudge"])
def test_impact(tiny, monkeypatch, fault):
    import surtr_tpu_torch.scene as scene

    if fault:
        orig = scene.do_fracture
        change = _drop_half if fault == "drop_half" else _nudge

        def broken(*a, **kw):
            pieces, met = orig(*a, **kw)
            return change(pieces), met

        monkeypatch.setattr(scene, "do_fracture", broken)
    rc, res, err = run_cpu(*tiny, "torus_scene.impact", seed=3_000_000_011)
    assert rc == 0, err
    assert res["correct"] is (fault is None), res["checks"]


@pytest.mark.parametrize("fault", [None, "step_unchanged"])
def test_frames(tiny, monkeypatch, fault):
    import surtr_tpu_torch.scene as scene

    if fault:
        monkeypatch.setattr(scene, "physics_step", lambda phys, cfg: phys)
    rc, res, err = run_cpu(*tiny, "torus_scene.frames", seed=3_000_000_013)
    assert rc == 0, err
    assert res["correct"] is (fault is None), res["checks"]


@pytest.mark.parametrize("workload", ["pumpkin_1k.decompose", "torus_scene.impact"])
def test_control_fails_a_number(tiny, workload):
    import io

    import control
    from pblib.harness import Spec

    spec = Spec(*tiny)
    least = control.main(["--workload", workload, "--seeds", "5"], *tiny, out=io.StringIO())
    limits = spec.cell(workload)["limits"]
    assert any(v > limits[k] for k, v in least.items()), least


def test_readings_of_the_program(tiny):
    import io

    import readings

    most = readings.main(["--workload", "pumpkin_1k.decompose", "--seeds", "4", "5"], "cpu",
                         *tiny, out=io.StringIO())
    assert most == {"piece_slots": 0, "piece_gap": 0.0}
