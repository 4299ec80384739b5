"""On the card: a short run of each cell of BENCHMARK.json prints a correct
result with the device's name and its end-to-end metrics (``python3 -m
pytest portbench/tests -m card`` on a machine with an H100)."""

import io
import json
import os
import time

import pytest

from conftest import ROOT


@pytest.mark.card
def test_short_run_of_each_cell_on_the_card(card):
    from pblib.harness import run

    bench = os.path.join(ROOT, "BENCHMARK.json")
    with open(bench) as fh:
        cells = [w["name"] for w in json.load(fh)["workloads"]]
    for workload in cells:
        out, err = io.StringIO(), io.StringIO()
        rc = run(["--workload", workload, "--seed", "3000000001", "--seconds", "2", "--trace",
                  "0"], time.perf_counter(), bench=bench, out=out, err=err)
        assert rc == 0, err.getvalue()[-2000:]
        res = json.loads(out.getvalue().strip().splitlines()[-1])
        assert res["correct"] and res["device"]["platform"] == "gpu", res
        assert {"setup_s", "events_per_s"} <= set(res["metrics"])
