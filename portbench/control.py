"""The control of the comparison that decides ``correct``: the reference
put in the program's place and computed one precision lower than the
configuration states (bfloat16 for its float32), read by the cell's own
numbers against the float32 reference, on the seeds given:

    python3 portbench/control.py --workload <cell> --seeds <n> <n> <n>

``decompose`` runs the reference's whole ``prepare_fracture`` on the model
in bfloat16 (the dtype its computation follows) and the seeds rounded to
bfloat16; ``impact`` and ``frames`` run the reference's ``do_fracture`` in
bfloat16 inside its float32 click or frame (its output cast back), the
frame from the reference's prepared Scene. Everything runs on the CPU, at
the cell's own sizes. One JSON line a seed, then a summary line with each
number's smallest reading."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import types

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [p for p in (HERE, os.path.dirname(HERE)) if p not in sys.path]

import torch  # noqa: E402

from pblib import compare, harness, scenes, traffic  # noqa: E402


def low(t):
    return t.to(torch.bfloat16) if t.is_floating_point() else t


def high(t):
    return t.float() if t.is_floating_point() else t


def bf16_fracture(do_fracture):
    """``do_fracture`` computed in bfloat16: its floating inputs cast down,
    its outputs cast back to float32."""
    def run(pieces, ctx, impact, target, cfg, partial=True):
        out, met = do_fracture(compare.tree_map(pieces, low), compare.tree_map(ctx, low),
                               low(torch.as_tensor(impact)), target, cfg, partial=partial)
        return compare.tree_map(out, high), compare.tree_map(met, high)
    return run


def readings(workload: str, seed: int, spec) -> dict:
    w = spec.workload(workload)
    cell, config = spec.cell(workload), spec.config(w["config"])
    driver = harness.load_file(spec.find("drivers", cell["driver"], ".py"), "driver")
    with tempfile.TemporaryDirectory(prefix="portbench_") as tmp:
        ctx = harness.Ctx(workload, seed, 0.0, False, torch.device("cpu"), cell, config, tmp)
        i = traffic.sample_index(seed, cell["sample_below"])
        st = types.SimpleNamespace(ctx=ctx)
        if cell["driver"] == "decompose":
            from pblib import meshes

            st.path = meshes.write_obj(*meshes.mesh(config["mesh"]), tmp, config["name"])
            want, scale, wmet = driver.reference(st, i)
            got, _, gmet = driver.reference(st, i, torch.bfloat16)
            return driver.numbers(got, gmet, want, wmet, scale)
        if cell["driver"] == "impact":
            want_p, want_b, scale = driver.reference(st, i)
            got_p, got_b, _ = driver.reference(st, i, fracture=bf16_fracture)
            return scenes.numbers(got_p, got_b, want_p, want_b, scale)
        ref = scenes.build("plainref", config, "cpu")
        before = (ref.pieces, ref.phys, ref._x0)
        scale = float(ref.ctx.max_axis_scale)
        want = driver.reference_frame(st, i, before, ref)
        got = driver.reference_frame(st, i, before, ref, fracture=bf16_fracture)
        return {**scenes.numbers(got[0], got[1], want[0], want[1], scale),
                **compare.image_gap(got[2], want[2])}


def main(argv=None, bench=None, search=None, out=sys.stdout) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    spec = harness.Spec(bench or os.path.join(harness.ROOT, "BENCHMARK.json"),
                        search or [harness.HERE])
    least = {}
    for seed in a.seeds:
        r = readings(a.workload, seed, spec)
        print(json.dumps({"workload": a.workload, "seed": seed, **r}), file=out, flush=True)
        for k, v in r.items():
            least[k] = min(least.get(k, v), v)
    print(json.dumps({"workload": a.workload, "least": least}), file=out, flush=True)
    return least


if __name__ == "__main__":
    main()
