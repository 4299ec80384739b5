#!/usr/bin/env python3
"""Peak device memory and time of the exact caps (``cap_fans_batch``) at
the concave path's calls, over the whole candidate batch and in slices of
candidates (the PyTorch/CUDA port, one GPU).

    python3 tools/caps_peak_memory.py [--slice 256] [--out PATH.json]

Records the ``cap_fans_batch`` calls of the torus decomposition at
BASELINE config 1 (``workload.MODEL_1K_CFG``; the parity grid answers the
probes) and of one ``fire_impact`` of each concave Scene
(``workload.concave_scene``, built on the card; ray-parity probes against
each candidate's solid). Per call it prints the candidates N, then for the
whole batch and for slices of ``--slice`` candidates run one after
another: the peak of ``torch.cuda.max_memory_allocated`` above the memory
held before the call, and CUDA-event ms (median of 5). The slices'
outputs, concatenated, are held bit for bit against the whole batch's.
With --out the results are written as JSON, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from surtr_tpu_torch import workload  # noqa: E402
from surtr_tpu_torch.fracture import pipeline  # noqa: E402
from surtr_tpu_torch.ops.caps import cap_fans_batch  # noqa: E402


def record(run) -> list:
    """The (args, kwargs) of every ``cap_fans_batch`` call ``run`` makes."""
    calls = []

    def rec(*a, **kw):
        calls.append((a, kw))
        return cap_fans_batch(*a, **kw)

    pipeline.cap_fans_batch = rec
    try:
        run()
        torch.cuda.synchronize()
    finally:
        pipeline.cap_fans_batch = cap_fans_batch
    return calls


def sliced(a, kw, n: int):
    """``cap_fans_batch`` over slices of ``n`` candidates, outputs joined."""
    conv, *per_cand = a[:7]
    N = per_cand[0].shape[0]
    parts = [cap_fans_batch(conv.map(lambda x: x[i:i + n]), *(x[i:i + n] for x in per_cand),
                            *a[7:], **kw) for i in range(0, N, n)]
    return (*(torch.cat(x) for x in zip(*(p[:4] for p in parts))), sum(p[4] for p in parts))


def measure(fn, reps: int = 5) -> dict:
    """Peak bytes above the memory held before one call, and the median
    CUDA-event ms of ``reps`` calls."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ts = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return {"peak_bytes": int(peak), "ms": statistics.median(ts)}, out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slice", type=int, default=256)
    ap.add_argument("--out")
    args = ap.parse_args()
    card = workload.card()
    print(card, flush=True)
    events = {"torus config 1": lambda: workload.run_prepare(
        "cuda", workload.MODEL_1K_CFG, workload.CONCAVE_MODEL)}
    for model in ("torus", "blob"):
        sc = workload.concave_scene(model, "cuda")
        events[f"Scene({model!r}) impact"] = (
            lambda sc=sc, model=model: sc.fire_impact(*workload.CONCAVE_RAYS[model]))
    res = {"card": card, "slice": args.slice, "device_bytes":
           torch.cuda.get_device_properties(0).total_memory, "calls": []}
    for what, run in events.items():
        for a, kw in record(run):
            whole, w_out = measure(lambda: cap_fans_batch(*a, **kw))
            part, p_out = measure(lambda: sliced(a, kw, args.slice))
            for x, y in zip(w_out, p_out):
                if not torch.equal(x.view(torch.int32) if x.is_floating_point() else x,
                                   y.view(torch.int32) if y.is_floating_point() else y):
                    raise SystemExit(f"{what}: the sliced caps differ from the whole batch's")
            r = {"event": what, "N": int(a[2].shape[0]), "Ts": int(a[5].shape[1]),
                 "grid": kw.get("solid_grid") is not None, "whole": whole, "sliced": part}
            res["calls"].append(r)
            print(f"{what}: cap_fans_batch N = {r['N']}, Ts = {r['Ts']}, "
                  f"{'grid' if r['grid'] else 'ray parity'}: whole batch peak "
                  f"{whole['peak_bytes'] / 2**30:.3f} GiB, {whole['ms']:.3f} ms; slices of "
                  f"{args.slice} peak {part['peak_bytes'] / 2**30:.3f} GiB, {part['ms']:.3f} ms; "
                  f"outputs equal ({card})", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()
