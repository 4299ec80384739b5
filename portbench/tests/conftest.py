"""Fixtures of the benchmark's own tests: the harness on the CPU at tiny
sizes (the program's CPU path is its plain path), and the ``card`` marker
for tests that need the H100, which skip here inside a fixture."""

import io
import json
import os
import sys

import pytest

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
sys.path[:0] = [p for p in (PB, ROOT) if p not in sys.path]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def tiny_bench(directory) -> tuple:
    """A BENCHMARK.json with the real cells' configurations shrunk (fewer
    cells, pieces and pixels; the same drivers, traffic and limits), and
    the cells kept as files beside them, its cells and configurations in
    ``directory``: (bench path, search dirs)."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    os.makedirs(os.path.join(directory, "cells"), exist_ok=True)
    os.makedirs(os.path.join(directory, "configs"), exist_ok=True)
    shrink = {
        "pumpkin_1k": lambda c: (c["mesh"].update(nu=24, nv=12), c["fracture"].update(
            initial_decompose_cell_cnt=64, max_pieces=128, max_faces=32, max_face_verts=16)),
        "torus_scene": lambda c: (c["scene"]["fracture"].update(
            general_pattern_cell_cnt=32, partial_pattern_cell_cnt=16, max_pieces=64,
            initial_decompose_cell_cnt=16, max_piece_tris=128, max_mesh_tris=512),
            c["scene"]["render"].update(width=64, height=64, shadow_size=64)),
    }
    # The cells kept as files for a later change (out of BENCHMARK.json)
    # run here too: their configuration, cells and tail metrics are added.
    listed = {w["name"] for w in bench["workloads"]}
    for path in sorted(os.listdir(os.path.join(PB, "cells"))):
        name = path[:-len(".json")]
        if name in listed:
            continue
        with open(os.path.join(PB, "cells", path)) as fh:
            cfg_name = json.load(fh)["config"]
        if cfg_name not in {c["name"] for c in bench["configs"]}:
            bench["configs"].append({"name": cfg_name, "source": "kept", "reduced": [],
                                     "file": f"portbench/configs/{cfg_name}.json", "why": "kept"})
        bench["workloads"].append({"name": name, "config": cfg_name, "traffic": name.split(".")[1],
                                   "chips": 1, "why": "kept"})
        tail = {"impact": "impact_ms_p95", "frames": "frame_ms_p95"}[name.split(".")[1]]
        bench["end_to_end"].append({"name": tail, "unit": "ms", "better": "lower", "bound": 0.25,
                                    "source": "host_clock", "workloads": [name]})
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        shrink[c["name"]](cfg)
        c["file"] = os.path.join("configs", c["name"] + ".json")
        with open(os.path.join(directory, c["file"]), "w") as fh:
            json.dump(cfg, fh)
    for w in bench["workloads"]:
        with open(os.path.join(PB, "cells", w["name"] + ".json")) as fh:
            cell = json.load(fh)
        cell.update(warm_events=1, trace_events=1, sample_below=2)
        with open(os.path.join(directory, "cells", w["name"] + ".json"), "w") as fh:
            json.dump(cell, fh)
    path = os.path.join(directory, "BENCHMARK.json")
    with open(path, "w") as fh:
        json.dump(bench, fh)
    return path, [str(directory), PB]


def run_cpu(bench, search, workload, seed=7, seconds=0.5, trace=0):
    """One harness run on the CPU → (exit code, parsed last line or None,
    standard error)."""
    import time

    from pblib.harness import run

    out, err = io.StringIO(), io.StringIO()
    rc = run(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
              "--trace", str(trace)], time.perf_counter(), device="cpu", bench=bench,
             search=search, out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None), err.getvalue()


@pytest.fixture
def tiny(tmp_path):
    return tiny_bench(tmp_path)
