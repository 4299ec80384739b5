#!/usr/bin/env python3
"""Where the time of one ``prepare_fracture`` event goes in the PyTorch/CUDA
port (cube, 1k-seed bench configuration, one GPU).

    python3 tools/profile_torch_prepare.py [--out PATH.json]

Prints (and with --out writes as JSON):
  * per stage: host-clock ms with a synchronize at both ends, median of 5
    events (stages are the pipeline's own functions, wrapped here);
  * from torch.profiler over 3 events: device busy ms and device kernel
    launches per event (all kernels), the idle share of the event's wall
    time, and the top 15 device kernels by time.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from surtr_tpu_torch import workload  # noqa: E402
from surtr_tpu_torch.fracture import pipeline  # noqa: E402

STAGES = ["ich", "kdop_planes", "_cell_plane_sets", "pattern_cells", "_two_pass_cell_clip",
          "_active_planes", "clip_trisoup", "_split_mesh_islands", "_finish_pieces",
          "_pack_candidates"]


def stage_breakdown(events: int = 5):
    times = {s: [] for s in STAGES}
    saved = {}
    for name in STAGES:
        fn = getattr(pipeline, name)
        saved[name] = fn

        def wrapped(*a, _fn=fn, _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            times[_name][-1] += (time.perf_counter() - t0) * 1e3
            return out

        setattr(pipeline, name, wrapped)
    try:
        for s in STAGES:
            times[s].append(0.0)
        workload.run_prepare("cuda")  # warm-up
        for s in STAGES:
            times[s].clear()
        for _ in range(events):
            for s in STAGES:
                times[s].append(0.0)
            workload.run_prepare("cuda")
    finally:
        for name, fn in saved.items():
            setattr(pipeline, name, fn)
    return {s: statistics.median(v) for s, v in times.items()}


def device_profile(events: int = 3):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    workload.run_prepare("cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(events):
            workload.run_prepare("cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / events
    rows = []
    busy_us = 0.0
    n_launch = 0
    for e in prof.key_averages():
        # Device-side kernel entries only: the CPU ops that launched them
        # carry the same time again.
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((e.key, dev_us / events / 1e3, e.count // events))
            busy_us += dev_us
            n_launch += e.count
    rows.sort(key=lambda r: -r[1])
    busy_ms = busy_us / events / 1e3
    return {
        "wall_ms_per_event": wall_ms,
        "device_busy_ms_per_event": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms if wall_ms > 0 else None,
        "device_launches_per_event": n_launch / events,
        "top_kernels": [{"name": k[:90], "ms_per_event": ms, "launches_per_event": n}
                        for k, ms, n in rows[:15]],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the results here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_prepare: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    card = workload.card()
    stages = stage_breakdown()
    dev = device_profile()
    res = {"card": card, "stages_ms": stages, **dev}
    print(card)
    for s, ms in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  stage {s:22s} {ms:9.3f} ms")
    print(f"  wall {dev['wall_ms_per_event']:.3f} ms/event, device busy "
          f"{dev['device_busy_ms_per_event']:.3f} ms in "
          f"{dev['device_launches_per_event']:.0f} launches, idle share {dev['idle_share']:.3f}")
    for r in dev["top_kernels"]:
        print(f"  {r['ms_per_event']:8.3f} ms  x{r['launches_per_event']:<5d} {r['name']}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()
