"""The harness finds what a later change adds as files: a cell, its
configuration, a driver and a metric, in a directory of their own."""

import json
import os

from conftest import run_cpu

DRIVER = '''
import types
def setup(ctx): return types.SimpleNamespace(n=0, ctx=ctx)
def warm(st): pass
def event(st, i):
    st.n += 1
    return True
def check(st, n): return [("events_seen", float(abs(st.n - n)), 0.0)]
'''
METRIC = '''
def read(rec): return float(len(rec.latencies))
'''


def test_a_cell_added_as_files_runs(tmp_path):
    from conftest import ROOT

    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for d in ("cells", "configs", "drivers", "metrics"):
        (tmp_path / d).mkdir()
    (tmp_path / "configs" / "noop.json").write_text(json.dumps({"name": "noop"}))
    (tmp_path / "cells" / "noop.count.json").write_text(json.dumps(
        {"config": "noop", "driver": "count", "limits": {"events_seen": 0}}))
    (tmp_path / "drivers" / "count.py").write_text(DRIVER)
    (tmp_path / "metrics" / "events_counted.py").write_text(METRIC)
    bench["configs"].append({"name": "noop", "source": "none", "file": "configs/noop.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "noop.count", "config": "noop", "traffic": "count",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "events_counted", "unit": "events", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["noop.count"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    from conftest import PB

    rc, res, err = run_cpu(str(path), [str(tmp_path), PB], "noop.count", seconds=0.2)
    assert rc == 0, err
    assert res["correct"] and res["attempted"] > 0
    assert set(res["metrics"]) == {"events_counted", "events_per_s", "setup_s"}
    assert res["metrics"]["events_counted"]["value"] == res["attempted"]
    assert list(res)[-1] == "checks"


def test_unknown_cell_prints_no_result(tiny):
    rc, res, err = run_cpu(*tiny, "no_such.cell")
    assert rc != 0 and res is None and "no_such.cell" in err
