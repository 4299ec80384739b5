"""The readers of the program's spans (``pblib/spans.py`` and the nine
``metrics/*.py`` that use it) against hand-made span records, and a traced
run of the decompose cell on the CPU that prints them."""

import json
import os
import sys
import types

import pytest

from conftest import PB, run_cpu
from pblib import spans
from pblib.harness import Records, load_file

STAGES = ["hull_cells", "cell_clip", "mesh_clip", "islands", "finish", "pack"]
READERS = {f"{s}_ms": s for s in STAGES} | {"caps_span_ms": "caps"}
NEW = [*READERS, "kernel_ms", "syncs_per_event"]


def reader(name):
    return load_file(f"{PB}/metrics/{name}.py", f"test_reader_{name}")


def span(name, parent, device_ms, syncs=0):
    return types.SimpleNamespace(name=name, parent=parent, device_ms=device_ms, syncs=syncs)


def call(k):
    """A prepare call whose numbers grow with ``k``: stage i reads i + k ms,
    caps 0.5 + k under finish, two kernel spans (one with a nested kernel
    span that must not count twice), 1 + k syncs."""
    out = [span("prepare", -1, 100.0 + k, syncs=1)]
    for i, s in enumerate(STAGES):
        out.append(span(s, 0, i + k))
        if s == "finish":
            out.append(span("caps", len(out) - 1, 0.5 + k, syncs=k))
        if s == "cell_clip":
            out.append(span("kernel.clip_fold", len(out) - 1, 0.25))
            out.append(span("kernel.clip_fold", len(out) - 2, 0.25))
            out.append(span("kernel.inner", len(out) - 1, 0.125))
    return out


@pytest.fixture
def program(monkeypatch):
    """A stand-in for the program's profiling module, recording ``held``."""
    held = []
    mod = types.SimpleNamespace(calls=lambda: list(held))
    monkeypatch.setitem(sys.modules, spans.PROGRAM, mod)
    return held


def rec(events):
    return Records(profile={"events": events})


def test_readers_take_the_calls_after_the_first(program):
    program[:] = [[span("other", -1, 9.0)], call(100), call(1), call(3)]
    r = rec(2)
    for name, stage in READERS.items():
        base = 0.5 if stage == "caps" else STAGES.index(stage)
        assert reader(name).read(r) == pytest.approx(base + 2), name
    assert reader("kernel_ms").read(r) == pytest.approx(0.5)
    assert reader("syncs_per_event").read(r) == pytest.approx(1 + 2)


def test_one_call_is_its_own_window(program):
    program[:] = [call(4)]
    assert reader("pack_ms").read(rec(1)) == pytest.approx(5 + 4)


@pytest.mark.parametrize("held, events", [(3, 1), (3, 3), (1, 2), (0, 1)])
def test_none_when_the_count_of_calls_does_not_match(program, held, events):
    program[:] = [call(k) for k in range(held)]
    for name in NEW:
        assert reader(name).read(rec(events)) is None, name


def test_none_without_a_trace_or_a_program_that_keeps_spans(monkeypatch, program):
    program[:] = [call(0), call(1)]
    for name in NEW:
        assert reader(name).read(Records()) is None
    monkeypatch.setitem(sys.modules, spans.PROGRAM, types.SimpleNamespace())
    for name in NEW:
        assert reader(name).read(rec(1)) is None


def test_none_where_a_call_lacks_the_stage(program):
    program[:] = [call(0), call(1), [span("prepare", -1, 1.0)]]
    assert reader("islands_ms").read(rec(2)) is None
    assert reader("syncs_per_event").read(rec(2)) == pytest.approx((2 + 0) / 2)


def test_a_traced_run_of_the_decompose_cell_prints_the_nine(tiny):
    from surtr_tpu_torch import profiling

    bench, search = tiny
    path = os.path.join(search[0], "cells", "pumpkin_1k.decompose.json")
    with open(path) as fh:
        cell = json.load(fh)
    cell["trace_events"] = 3
    with open(path, "w") as fh:
        json.dump(cell, fh)
    profiling.clear_calls()
    rc, res, err = run_cpu(bench, search, "pumpkin_1k.decompose", seed=3000000001, trace=1)
    assert rc == 0 and res["correct"], err[-2000:]
    got = {n.split(".")[0]: v["value"] for n, v in res["metrics"].items()}
    assert set(NEW) <= set(got)
    prep = [c for c in profiling.calls() if c[0].name == "prepare"][1:]
    assert len(prep) == 2
    whole = sum(c[0].device_ms for c in prep) / 2
    stages = sum(got[f"{s}_ms"] for s in STAGES)
    assert 0.99 * whole <= stages <= whole
    assert got["caps_span_ms"] < got["finish_ms"]
    assert got["kernel_ms"] == 0 and got["syncs_per_event"] == 0   # the CPU path
    profiling.clear_calls()
