"""The lower readings of the comparison that decides ``correct``: for each
seed, the program's event at the seed's sampled index (the event a run
holds against the reference) computed on the card and compared with the
reference, as a run's check does, without the measured window:

    python3 portbench/readings.py --workload <cell> --seeds <n> <n> ...

One JSON line a seed, then each number's largest reading."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [p for p in (HERE, os.path.dirname(HERE)) if p not in sys.path]

import torch  # noqa: E402

from pblib import harness, traffic  # noqa: E402


def main(argv=None, device="cuda", bench=None, search=None, out=sys.stdout) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    spec = harness.Spec(bench or os.path.join(harness.ROOT, "BENCHMARK.json"),
                        search or [harness.HERE])
    w = spec.workload(a.workload)
    cell, config = spec.cell(a.workload), spec.config(w["config"])
    driver = harness.load_file(spec.find("drivers", cell["driver"], ".py"), "driver")
    most = {}
    for seed in a.seeds:
        with tempfile.TemporaryDirectory(prefix="portbench_") as tmp:
            ctx = harness.Ctx(a.workload, seed, 0.0, False, torch.device(device), cell, config,
                              tmp)
            st = driver.setup(ctx)
            i = traffic.sample_index(seed, cell["sample_below"])
            driver.event(st, i)
            r = {k: v for k, v, _ in driver.check(st, i + 1)}
        print(json.dumps({"workload": a.workload, "seed": seed, "event": i, **r}), file=out,
              flush=True)
        for k, v in r.items():
            most[k] = max(most.get(k, v), v)
    print(json.dumps({"workload": a.workload, "most": most}), file=out, flush=True)
    return most


if __name__ == "__main__":
    main()
