"""The port's spans (``surtr_tpu_torch.profiling.span``) on the CPU: on
exactly while torch.profiler records, the stage spans of
``prepare_fracture``, their ranges in the profiler's trace, truncation at
``profile_stage``, the ring of calls, the sync count's attribution, and a
span on each kernel launcher that ``prepare_fracture`` runs, kept only inside
an open call.

``prepare_fracture`` runs on the blob (320 triangles: exact caps and the
island split) at 8 cells, about a second a run.
"""

import gc
import json
import os
import sys
import warnings

import pytest
import torch
from torch_threads import bounded_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from surtr_tpu_torch import profiling  # noqa: E402

CFG = dict(max_faces=26, max_face_verts=16, voronoi_prefix=8, partial_pattern_cell_cnt=8,
           general_pattern_cell_cnt=8, initial_decompose_cell_cnt=8, max_pieces=8,
           max_piece_tris=64, voronoi_neighbors=15)
STAGES = ["hull_cells", "cell_clip", "mesh_clip", "islands", "finish", "pack"]
# The launchers that ``prepare_fracture`` runs, each spanned as
# ``kernel.<its csrc/*.cu file>``; the physics and render launchers open no span.
LAUNCHERS = [("ops.clip_cuda", "_kernel", "clip_fold"), ("ops.hull_cuda", "_kernel", "ich"),
             ("ops.labels_cuda", "_kernel", "labels"), ("ops.refit_cuda", "_parts_kernel", "refit"),
             ("ops.soup_clip_cuda", "_kernel", "soup_clip")]
UNSPANNED = [("physics.pack_cuda", "_kernel"), ("physics.prep_cuda", "_kernel"),
             ("physics.narrowphase_cuda", "_kernel"), ("physics.solver_cuda", "_solve_kernel"),
             ("physics.broadphase_cuda", "_exact_kernel"),
             ("physics.broadphase_cuda", "_sorted_launch"), ("render.raster_cuda", "_kernel"),
             ("render.raster_cuda", "_glue_kernel")]


def _prepare(profile_stage=99):
    from surtr_tpu_torch.config import FractureConfig
    from surtr_tpu_torch.fracture.pipeline import prepare_fracture
    from surtr_tpu_torch.workload import model_inputs

    return prepare_fracture(*model_inputs("blob", "cpu"), FractureConfig(**CFG),
                            generator=torch.Generator().manual_seed(5),
                            profile_stage=profile_stage)


def _profiled(fn, path=None):
    """``fn()`` under torch.profiler → (its output, the calls it recorded)."""
    from torch.profiler import profile

    profiling.clear_calls()
    with profile() as prof:
        out = fn()
    if path is not None:
        prof.export_chrome_trace(str(path))
    calls = profiling.calls()
    profiling.clear_calls()
    return out, calls


def _flat(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flat(v)]
    if hasattr(tree, "__dataclass_fields__"):
        return [t for k in tree.__dataclass_fields__ for t in _flat(getattr(tree, k))]
    return []


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One prepare with tracing off, one under the profiler (garbage
    collection held off, so no pause falls between two stages): (output
    off, output on, its calls, its Chrome trace's path)."""
    path = tmp_path_factory.mktemp("tracing") / "trace.json"
    off = _prepare()
    gc.disable()
    try:
        on, calls = _profiled(_prepare, path)
    finally:
        gc.enable()
    return off, on, calls, path


def test_prepare_records_one_call_of_six_stages_with_caps_under_finish(traced):
    _, _, calls, _ = traced
    assert len(calls) == 1
    call = calls[0]
    assert call[0].name == "prepare" and call[0].parent == -1
    children = [s.name for s in call if s.parent == 0]
    assert children == STAGES
    finish = next(i for i, s in enumerate(call) if s.name == "finish")
    assert [(s.name, s.parent) for s in call if s.parent == finish] == [("caps", finish)]
    assert {s.name for s in call} == {"prepare", "caps", *STAGES}   # no kernel on the CPU


def test_stage_spans_tile_the_prepare_span(traced):
    _, _, calls, _ = traced
    top, stages = calls[0][0], [s for s in calls[0] if s.parent == 0]
    assert top.t0_ns <= stages[0].t0_ns
    for a, b in zip(stages, stages[1:]):
        assert a.t0_ns < a.t1_ns <= b.t0_ns
    assert stages[-1].t1_ns <= top.t1_ns
    covered = sum(s.t1_ns - s.t0_ns for s in stages)
    assert top.t1_ns - top.t0_ns - covered < 0.01 * (top.t1_ns - top.t0_ns)
    for s in calls[0]:   # on the CPU the device clock is the host's
        assert s.device_ms == s.host_ms and s.syncs == 0


def test_chrome_trace_holds_the_same_ranges_nested_alike(traced):
    _, _, calls, path = traced
    with open(path) as fh:
        evs = [e for e in json.load(fh)["traceEvents"]
               if e.get("ph") == "X" and e.get("cat") == "user_annotation"
               and str(e.get("name", "")).startswith("surtr.")]
    evs.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
    call = calls[0]
    assert [e["name"] for e in evs] == ["surtr." + s.name for s in call]

    def inside(e, p):
        return (float(p["ts"]) <= float(e["ts"])
                and float(e["ts"]) + float(e["dur"]) <= float(p["ts"]) + float(p["dur"]))

    for i, s in enumerate(call):
        # The innermost range that holds this one is the span's parent.
        holders = [j for j, p in enumerate(evs) if j != i and inside(evs[i], p)]
        want = [] if s.parent < 0 else [s.parent]
        assert holders[-1:] == want, s.name


def test_outputs_are_bit_identical_with_tracing_on_and_off(traced):
    off, on, _, _ = traced
    a, b = _flat(off), _flat(on)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


def test_no_profiler_no_record_and_no_range(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler running")

    profiling.clear_calls()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiling.recording()
    _prepare(profile_stage=4)
    with profiling.span("outer"), profiling.span("inner"):
        pass
    assert profiling.calls() == []


def test_the_range_is_entered_while_the_profiler_records(monkeypatch):
    """The counterpart of the test above: the same patch is reached while
    torch.profiler records, so its silence there proves the gate."""
    def refuse(*a, **kw):
        raise RuntimeError("entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with pytest.raises(RuntimeError, match="entered"):
        _profiled(lambda: profiling.span("x").__enter__())
    assert profiling.calls() == []


@pytest.mark.parametrize("stage, stages", [
    (1, STAGES[:1]), (3, STAGES[:1]), (4, STAGES[:2]), (44, STAGES[:3]), (5, STAGES[:3]),
    (6, STAGES[:4]), (45, STAGES[:5]), (7, STAGES[:5])])
def test_a_truncated_run_records_the_stages_before_its_fence(stage, stages):
    out, calls = _profiled(lambda: _prepare(profile_stage=stage))
    assert out[1] is None and out[0].dim() == 0
    assert len(calls) == 1 and calls[0][0].name == "prepare"
    assert [s.name for s in calls[0] if s.parent == 0] == stages
    assert ("caps" in {s.name for s in calls[0]}) == (stage == 7)


def test_the_ring_keeps_the_last_64_calls():
    def many():
        for i in range(profiling.RING + 6):
            with profiling.span(f"call{i}"):
                with profiling.span("child"):
                    pass

    _, calls = _profiled(many)
    assert len(calls) == profiling.RING == 64
    assert [c[0].name for c in calls] == [f"call{i}" for i in range(6, 70)]
    assert all([(s.name, s.parent) for s in c[1:]] == [("child", 0)] for c in calls)


def test_calls_are_kept_until_cleared():
    def one():
        with profiling.span("a"):
            pass

    from torch.profiler import profile

    profiling.clear_calls()
    with profile():
        one()
        one()
    assert [c[0].name for c in profiling.calls()] == ["a", "a"]
    assert len(profiling.calls()) == 2   # reading does not clear
    profiling.clear_calls()
    assert profiling.calls() == []


def test_syncs_go_to_the_innermost_open_span_and_other_warnings_pass():
    """The count reads the sync debug mode's warnings; here they are raised
    by hand, since the CPU has no synchronisation to warn of."""
    def sync():
        warnings.warn(profiling.SYNC_WARNING)

    def body():
        with profiling.span("top"):
            sync()
            with profiling.span("a"):
                sync()
                sync()
                with profiling.span("b"):
                    sync()
                warnings.warn("something else", RuntimeWarning)
            sync()
            with profiling.span("c"):
                pass

    with pytest.warns(RuntimeWarning, match="something else") as got:
        _, calls = _profiled(body)
    assert not [w for w in got if profiling.SYNC_WARNING in str(w.message)]
    assert [(s.name, s.parent, s.syncs) for s in calls[0]] == [
        ("top", -1, 2), ("a", 0, 2), ("b", 1, 1), ("c", 0, 0)]


def _call_bare(launchers):
    """Each launcher with no arguments: its own body refuses them."""
    import importlib

    for module, attr, *_ in launchers:
        fn = getattr(importlib.import_module("surtr_tpu_torch." + module), attr)
        with pytest.raises(TypeError):
            fn()


def test_prepare_launchers_open_a_span_named_after_their_source_inside_a_call():
    files = {f[:-3] for f in os.listdir(os.path.join(REPO, "surtr_tpu_torch", "csrc"))
             if f.endswith(".cu")}
    assert {n for _, _, n in LAUNCHERS} <= files and len(LAUNCHERS) == 5

    def inside_a_call():
        with profiling.span("top"):
            _call_bare(LAUNCHERS + UNSPANNED)

    _, calls = _profiled(inside_a_call)
    assert [[(s.name, s.parent) for s in c] for c in calls] == [
        [("top", -1)] + [("kernel." + n, 0) for _, _, n in LAUNCHERS]]


def test_a_launcher_outside_a_call_records_nothing_and_opens_no_range(monkeypatch):
    """A launch outside any open span (``do_fracture``, a physics step) is
    not a call of its own: no record, no profiler range, no sync mode."""
    def refuse(*a, **kw):
        raise AssertionError("record_function entered outside a call")

    def bare():
        assert profiling.recording()
        monkeypatch.setattr(torch.profiler, "record_function", refuse)
        _call_bare(LAUNCHERS)

    _, calls = _profiled(bare)
    assert calls == []
