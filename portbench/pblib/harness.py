"""The benchmark's one entry: ``run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``.

Everything it runs is found by name: the cell in ``BENCHMARK.json``, its
file ``cells/<cell>.json`` (configuration, driver, traffic, limits), the
configuration's file, the driver ``drivers/<driver>.py``, each metric's
reader ``metrics/<name before the first dot>.py`` and each kernel's counts
``kernels/<kernel>.py``. So a later change adds a cell, a configuration, a
driver, a metric or a kernel by adding a file.

A run: look for the card, set up (the driver's set-up and its warm events
of the cell's own shapes), then a closed loop of events for ``--seconds``,
then the driver's comparison with the reference, and one JSON line. With
``--trace 1`` ``trace_events`` events run under torch.profiler first,
then the window's events with fenced spans, and the line carries the
cell's per-layer metrics instead of its end-to-end ones.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import importlib.util
import json
import math
import os
import sys
import tempfile
import time

BANNED = ("jax", "jaxlib", "flax", "surtr_tpu")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # portbench/
ROOT = os.path.dirname(HERE)


class Refused(Exception):
    """A run that prints no result."""


def banned_modules(names=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``BANNED``, compared whole: ``surtr_tpu_torch`` is not ``surtr_tpu``."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(BANNED))


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Ctx:
    """What a driver gets: the run's arguments, its cell and configuration
    (parsed JSON), the device, and a scratch directory under ``TMPDIR``."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    device: object
    cell: dict
    config: dict
    tmpdir: str


class Spec:
    """``BENCHMARK.json`` and the files it names, looked up in ``search``
    (directories holding ``cells/``, ``configs/``, ``drivers/``,
    ``metrics/`` and ``kernels/``; the first that has the file wins)."""

    def __init__(self, bench: str, search: list):
        with open(bench) as fh:
            self.bench = json.load(fh)
        self.base = os.path.dirname(os.path.abspath(bench))
        self.search = search

    def find(self, kind: str, name: str, ext: str) -> str:
        for d in self.search:
            p = os.path.join(d, kind, name + ext)
            if os.path.exists(p):
                return p
        raise Refused(f"no {kind}/{name}{ext} in {self.search}")

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise Refused(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.base, c["file"])) as fh:
                    return json.load(fh)
        raise Refused(f"no config {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        with open(self.find("cells", name, ".json")) as fh:
            return json.load(fh)

    def end_to_end(self, workload: str) -> list:
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or workload in m["workloads"]]

    def per_layer(self, workload: str) -> list:
        e2e = {m["name"] for m in self.end_to_end(workload)}

        def applies(m):
            return workload in m["workloads"] if "workloads" in m else m["moves"] in e2e

        return [m for m in self.bench["per_layer"] if applies(m)]

    def reader(self, metric: str):
        base = metric.split(".")[0]
        return load_file(self.find("metrics", base, ".py"), f"portbench_metric_{base}")

    def kernels(self) -> dict:
        out = {}
        for d in reversed(self.search):
            for p in sorted(glob.glob(os.path.join(d, "kernels", "*.py"))):
                name = os.path.basename(p)[:-3]
                out[name] = load_file(p, f"portbench_kernel_{name}")
        return out


@dataclasses.dataclass
class Records:
    """What the metric readers read. End to end: ``setup_s``, every event's
    latency in seconds, the events completed and the window's length. In a
    traced run also: ``profile`` (``tracing.read_trace`` of the profiled
    events), ``bounds`` (each kernel call's bound in the first profiled
    event), the fenced
    spans' seconds and calls over ``fenced_events`` events, and the
    program's launch counters over the profiled events."""

    setup_s: float = math.nan
    latencies: list = dataclasses.field(default_factory=list)
    completed: int = 0
    window_s: float = math.nan
    profile: dict = dataclasses.field(default_factory=dict)
    bounds: list = dataclasses.field(default_factory=list)
    span_s: dict = dataclasses.field(default_factory=dict)
    span_calls: dict = dataclasses.field(default_factory=dict)
    fenced_events: int = 0
    counted_launches: int = 0
    card: str = ""


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _launch_counters(kinds) -> int:
    """The sum of the program's ``launches`` counters over the modules the
    kernel files name."""
    mods = {k.MODULE for k in kinds.values()}
    total = 0
    for m in mods:
        mod = sys.modules.get(m)
        for attr in ("launches", "exact_launches", "sorted_launches", "glue_launches"):
            total += int(getattr(mod, attr, 0) or 0)
    return total


def run(argv, t_start: float, device=None, bench=None, search=None, out=sys.stdout,
        err=sys.stderr) -> int:
    """One run; returns the exit code. ``device`` set (the tests give
    "cpu") skips the look for a card; ``bench`` and ``search`` point at
    another BENCHMARK.json and other directories of cells and files."""
    a = _args(argv)
    spec = Spec(bench or os.path.join(ROOT, "BENCHMARK.json"), search or [HERE])
    try:
        return _run(a, spec, t_start, device, out, err)
    except Refused as e:
        print(f"portbench: {e}", file=err)
        return 2


def _run(a, spec, t_start, device, out, err) -> int:
    import torch

    from pblib import tracing
    from pblib.bounds import card

    w = spec.workload(a.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
            raise Refused(f"{a.workload} needs {w['chips']} CUDA device(s); found "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = "cuda"
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cell = spec.cell(a.workload)
    config = spec.config(w["config"])
    driver = load_file(spec.find("drivers", cell["driver"], ".py"), f"portbench_driver_{cell['driver']}")
    rec = Records()
    # One host thread while the program runs: the program's host work is
    # dispatch, and idle intra-op workers only contend for the host's cores.
    # The reference gets them all back after the window.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory(prefix="portbench_") as tmp:
        ctx = Ctx(a.workload, a.seed, a.seconds, bool(a.trace), dev, cell, config, tmp)
        state = driver.setup(ctx)
        driver.warm(state)
        if on_card:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        rec.setup_s = t0 - t_start

        i = failed = 0
        kinds = spans = None
        if a.trace:
            kinds = tracing.KernelCalls(spec.kernels())
            kinds.install()
            n_prof = int(cell.get("trace_events", 4))
            c0 = _launch_counters(kinds.kinds)
            kinds.recording = True
            prof = tracing.profile_events(lambda k: _timed(driver, state, k), 0, n_prof, tmp,
                                          after_first=kinds.count)
            kinds.count()
            rec.counted_launches = _launch_counters(kinds.kinds) - c0
            for lat, ok in prof.pop("results"):
                rec.latencies.append(lat)
                failed += not ok
            rec.profile = prof
            i = n_prof
            sites = {}
            for m in spec.per_layer(a.workload):
                sites.update(getattr(spec.reader(m["name"]), "SPANS", {}))
            spans = tracing.Spans(sites, dev)
            spans.install()
            f0 = i
            t0 = time.perf_counter()
        while time.perf_counter() - t0 < a.seconds or i == 0:
            lat, ok = _timed(driver, state, i)
            rec.latencies.append(lat)
            failed += not ok
            i += 1
        t1 = time.perf_counter()
        rec.window_s = t1 - t0
        rec.completed = i - failed
        if a.trace:
            spans.uninstall()
            kinds.uninstall()
            rec.fenced_events = i - f0
            rec.span_s, rec.span_calls = dict(spans.seconds), dict(spans.counts)
            rec.bounds = kinds.bounds
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
        rec.card = card() if on_card else "cpu"

        metrics = {}
        names = spec.per_layer(a.workload) if a.trace else spec.end_to_end(a.workload)
        for m in names:
            v = spec.reader(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        torch.set_num_threads(threads)
        checks = driver.check(state, i)

    banned = banned_modules()
    if banned:
        print(f"portbench: loaded {', '.join(banned)}, which the benchmark must not run",
              file=err)
        return 3
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    res = {"correct": correct, "attempted": i, "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1,
                      "memory_peak_bytes": int(peak)}}
    if a.trace and rec.profile:
        res["device"].update(busy_s=rec.profile["busy_s"], window_s=rec.profile["window_s"])
        res["breakdown"] = {"device_ops": [list(x) for x in rec.profile["device_ops"]],
                            "idle_gaps": rec.profile["idle_gaps"]}
    if a.trace:
        res["card"] = rec.card   # name and power limit, beside the roofline shares
    res["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    if a.trace:
        p = rec.profile
        print(f"portbench: card {rec.card}; profiled {p.get('events')} events, "
              f"{p.get('device_records')} device records, {rec.counted_launches} kernel "
              f"launches by the program's counters", file=err)
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r}", file=err)
    err.flush()
    print(json.dumps(res), file=out)
    out.flush()
    return 0


def _timed(driver, state, i):
    t = time.perf_counter()
    ok = driver.event(state, i)
    return time.perf_counter() - t, bool(ok)
