"""What the traced run reads: kernel calls recorded at the program's kernel
wrappers, fenced spans around program functions, and the device timeline
of a torch.profiler trace (its exported Chrome trace)."""

from __future__ import annotations

import bisect
import importlib
import json
import os
import time
from collections import defaultdict

import torch

from pblib.bounds import bound_s, nbytes

EVENT = "portbench.event"
KERNEL = "portbench.kernel."
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
RUNTIME_CATS = {"cuda_runtime", "cuda_driver"}
HOST_CATS = {"cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver"}
NAME_CHARS = 100   # a device operation's or host range's name, cut to this


def _swap(module: str, attr: str, make):
    """Replace ``module.attr`` by ``make(original)``; returns the undo."""
    mod = importlib.import_module(module)
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    return lambda: setattr(mod, attr, orig)


class KernelCalls:
    """Every call of each kernel wrapper's launcher (``kernels/<name>.py``:
    MODULE, ATTR, ops), inside a ``record_function`` range named
    ``portbench.kernel.<name>``; while ``recording``, its arguments and
    result are held until ``count`` reckons each call's bound."""

    def __init__(self, kinds: dict):
        self.kinds = kinds
        self.recording = False
        self.calls = []          # (name, args, kwargs, out) in call order
        self.bounds = []         # (name, bound seconds) of the counted calls
        self.undo = []

    def install(self):
        for name, k in self.kinds.items():
            def make(orig, name=name):
                def call(*a, **kw):
                    with torch.profiler.record_function(KERNEL + name):
                        out = orig(*a, **kw)
                    if self.recording:
                        self.calls.append((name, a, kw, out))
                    return out
                return call
            self.undo.append(_swap(k.MODULE, k.ATTR, make))

    def uninstall(self):
        for u in reversed(self.undo):
            u()
        self.undo = []

    def count(self):
        """Stop recording; the recorded calls' (name, bound seconds) in call
        order go to ``bounds`` and their arguments are let go."""
        self.recording = False
        for name, a, kw, res in self.calls:
            k = self.kinds[name]
            self.bounds.append((name, bound_s(nbytes(a) + nbytes(kw) + nbytes(res),
                                              k.ops(a, kw))))
        self.calls = []


class Spans:
    """Fenced spans: the device is synchronised before and after each call
    of a wrapped program function, and the host clock between the two
    fences is the span."""

    def __init__(self, sites: dict, device):
        self.sites = sites       # span name → (module, attr)
        self.device = device
        self.seconds = defaultdict(float)
        self.counts = defaultdict(int)
        self.undo = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def install(self):
        for name, (module, attr) in self.sites.items():
            def make(orig, name=name):
                def call(*a, **kw):
                    self._sync()
                    t0 = time.perf_counter()
                    out = orig(*a, **kw)
                    self._sync()
                    self.seconds[name] += time.perf_counter() - t0
                    self.counts[name] += 1
                    return out
                return call
            self.undo.append(_swap(module, attr, make))

    def uninstall(self):
        for u in reversed(self.undo):
            u()
        self.undo = []


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_trace(path: str) -> dict:
    """The profiled window's device timeline from a Chrome trace: the
    window (from the second ``portbench.event`` host range's start to the
    last one's end), the device's busy time inside it, its operations, the ten
    longest idle gaps named by the innermost host range open in the middle
    of each, and each kernel call's device seconds in the first event (the
    device operations whose launches lie inside its
    ``portbench.kernel.<name>`` host range)."""
    with open(path) as fh:
        evs = [e for e in json.load(fh).get("traceEvents", []) if e.get("ph") == "X"]
    cat = lambda e: str(e.get("cat", "")).lower()  # noqa: E731
    ranges = [e for e in evs if cat(e) == "user_annotation"]
    events = sorted((e for e in ranges if e.get("name") == EVENT), key=lambda e: e["ts"])
    if not events:
        return {}
    # The first event carries the profiler's own start and holds its kernel
    # calls' arguments for their bounds: the window opens at the second.
    first = events[0]
    events = events[1:] if len(events) > 1 else events
    w0 = float(events[0]["ts"])
    w1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
    dev = [e for e in evs if cat(e) in DEVICE_CATS]
    inside = [e for e in dev if w0 <= float(e["ts"]) and float(e["ts"]) + float(e.get("dur", 0)) <= w1]
    busy = _merge([(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e.get("dur", 0)), w1))
                   for e in dev if float(e["ts"]) < w1 and float(e["ts"]) + float(e.get("dur", 0)) > w0])
    busy_us = sum(e - s for s, e in busy)

    per_name = defaultdict(float)
    for e in inside:
        per_name[e["name"][:NAME_CHARS]] += float(e.get("dur", 0)) * 1e-6
    device_ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]

    # Idle gaps inside the window, named by the innermost host range open
    # at the gap's middle on the thread that ran the events.
    tid = events[0].get("tid")
    host = sorted((e for e in evs if cat(e) in HOST_CATS and e.get("tid") == tid
                   and e.get("name") != EVENT and e.get("ts") is not None), key=lambda e: e["ts"])
    edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
    gaps = sorted(((edges[k + 1] - edges[k], edges[k]) for k in range(0, len(edges) - 1, 2)
                   if edges[k + 1] > edges[k]), reverse=True)[:10]
    idle = []
    for length, start in gaps:
        mid = start + length / 2
        name = "host (no range open)"
        best = None
        for h in host:
            if float(h["ts"]) > mid:
                break
            d = float(h.get("dur", 0))
            if float(h["ts"]) + d >= mid and (best is None or d < best):
                best, name = d, h["name"]
        idle.append([name[:NAME_CHARS], length * 1e-6])

    # Kernel calls: launches inside each portbench.kernel range → the
    # device operations with those correlation ids.
    by_corr = defaultdict(float)
    for e in dev:
        c = (e.get("args") or {}).get("correlation")
        if c is not None:
            by_corr[c] += float(e.get("dur", 0)) * 1e-6
    launches = defaultdict(list)
    for e in evs:
        if cat(e) in RUNTIME_CATS and (e.get("args") or {}).get("correlation") is not None:
            launches[e.get("tid")].append((float(e["ts"]), e["args"]["correlation"]))
    for v in launches.values():
        v.sort()
    calls = []
    c0, c1 = float(first["ts"]), float(first["ts"]) + float(first.get("dur", 0))
    for e in sorted((e for e in ranges if str(e.get("name", "")).startswith(KERNEL)
                     and c0 <= float(e["ts"]) <= c1), key=lambda e: e["ts"]):
        lst = launches.get(e.get("tid"), [])
        s, t = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        i = bisect.bisect_left(lst, (s, -1))
        secs = 0.0
        while i < len(lst) and lst[i][0] <= t:
            secs += by_corr.get(lst[i][1], 0.0)
            i += 1
        calls.append((e["name"][len(KERNEL):], secs))
    return {"events": len(events), "window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "device_records": len(inside), "device_ops": device_ops, "idle_gaps": idle,
            "kernel_calls": calls}


def profile_events(run_event, first: int, n: int, tmpdir: str, after_first=None) -> dict:
    """Events ``first`` .. ``first + n - 1`` under torch.profiler (CPU and
    CUDA), each inside a ``portbench.event`` range, ``after_first()`` called
    between the first and the second; the trace is written to ``tmpdir``,
    read by ``read_trace`` and deleted."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    results = []
    with profile(activities=acts) as prof:
        for i in range(first, first + n):
            with record_function(EVENT):
                results.append(run_event(i))
            if i == first and after_first is not None:
                after_first()
    path = os.path.join(tmpdir, "portbench_trace.json")
    prof.export_chrome_trace(path)
    try:
        out = read_trace(path)
    finally:
        os.remove(path)
    out["results"] = results
    return out
