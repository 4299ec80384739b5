"""BENCHMARK.json and the files it names, against the benchmark's rules."""

import json
import os
import re

from conftest import PB, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_keys_names_and_units():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert all(PATH.match(p) and ".." not in p for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32 and b["command"][1].startswith("portbench/")
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    assert len(json.dumps(b)) < 64 * 1024


def test_every_config_used_and_every_cell_reports_enough():
    b = bench()
    assert {c["name"] for c in b["configs"]} == {w["config"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for w in b["workloads"]:
        mine = [m for m in b["end_to_end"] if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(w["name"] in m.get("workloads", []) for m in b["per_layer"])


def test_per_layer_cells_report_what_they_move():
    b = bench()
    for m in b["per_layer"]:
        e = next(x for x in b["end_to_end"] if x["name"] == m["moves"])
        for cell in m["workloads"]:
            assert "workloads" not in e or cell in e["workloads"], (m["name"], cell)


def test_every_named_file_exists():
    b = bench()
    for w in b["workloads"]:
        with open(os.path.join(PB, "cells", w["name"] + ".json")) as fh:
            cell = json.load(fh)
        assert cell["config"] == w["config"]
        assert os.path.exists(os.path.join(PB, "drivers", cell["driver"] + ".py"))
        assert cell["limits"] and all(v >= 0 for v in cell["limits"].values())
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.exists(os.path.join(PB, "metrics", m["name"].split(".")[0] + ".py"))


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = bench()["run_seconds"]
    assert 2 * (rs + 60) + 14 * 24 * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
