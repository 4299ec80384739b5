"""The interactive frame at bench size, the port against the JAX package
over chained frames (ROADMAP C10).

    python3 tools/check_frames_c10.py [--frames 16] [--out FILE.json]

Runs on the CPU (every kernel's plain version). A child process runs the
JAX package, compiled with ``--xla_cpu_max_isa=AVX`` (no FMA contraction,
ROADMAP C5): ``Scene("cube", workload.INTERACTIVE_CFG)`` at the bench's
spawn, saved with its own ``save_scene``, then ``--frames`` chained
``interactive_frame`` calls with the bench's ray and camera
(bench.py:372-434). The port loads that snapshot
(``checkpoint.load_scene(..., device="cpu")``) and runs the same frames
(``workload.run_frames``), so both start from the same bits.

Per frame the tool prints both packages' overflow counters
(active, job, piece, split-face), the event counts (new and active pieces,
merged out, groups, mesh triangles dropped), the valid pieces, the
distinct groups and the tagged pieces among them, and the volume. The
frames are chaotic (ROADMAP C7): body states are compared only on the
first ``STATE_FRAMES`` frames (x within 2e-4, v within 2e-3, as
tests/test_torch_scene.py), and past them the counters and invariants.

Re-synced frames tell chaos from a fault: the JAX child saves its Scene
after every frame, and for each frame k >= 1 both packages load the
snapshot after frame k - 1 and run frame k alone; their counters and
volumes are compared as the chained first frame's are.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from surtr_tpu_torch import workload  # noqa: E402

OVERFLOWS = ("active_overflow", "job_overflow", "piece_overflow", "split_face_overflow")
COUNTS = ("new_pieces", "active_pieces", "merged_out", "num_groups", "mesh_tris_dropped")
STATE_FRAMES = 2
X_ATOL, V_ATOL = 2e-4, 2e-3


def frame_record(met, valid, group, tag, volume) -> dict:
    """One frame's counters and invariants (numpy arrays in)."""
    rec = {k: int(met[k]) for k in OVERFLOWS + COUNTS}
    rec["metric_volume"] = float(met["total_volume"])
    rec["valid"] = int(valid.sum())
    rec["groups"] = int(len(np.unique(group[valid])))
    rec["tagged"] = int((tag[valid] >= 0).sum())
    rec["volume"] = float(volume)
    return rec


def differ(a: dict, b: dict) -> list:
    """The records' keys that differ: counts exactly, volumes beyond rtol
    1e-5."""
    vols = ("volume", "metric_volume")
    return sorted([k for k in a if k not in vols and a[k] != b[k]]
                  + [k for k in vols if abs(a[k] - b[k]) > 1e-5 * abs(a[k])])


def jax_child(frames, out_dir):
    """Child-process side: the JAX package's Scene, its snapshot, and its
    frames' records and body states, written under ``out_dir``."""
    from surtr_tpu.checkpoint import save_scene
    from surtr_tpu.config import FractureConfig, PhysicsConfig, RenderConfig, SceneConfig
    from surtr_tpu.scene import Scene

    c = workload.INTERACTIVE_CFG
    cfg = SceneConfig(fracture=FractureConfig(**dataclasses.asdict(c.fracture)),
                      physics=PhysicsConfig(**dataclasses.asdict(c.physics)),
                      render=RenderConfig(**dataclasses.asdict(c.render)))
    from surtr_tpu.checkpoint import load_scene

    sc = Scene("cube", cfg, spawn=workload.FRAME_SPAWN)
    save_scene(os.path.join(out_dir, "init.npz"), sc)

    def frame(scene):
        _, met = scene.interactive_frame(*workload.FRAME_RAY, eye=workload.FRAME_EYE,
                                         target=workload.FRAME_TARGET)
        p = scene.pieces
        return frame_record({k: np.asarray(v) for k, v in met.items()}, np.asarray(p.valid),
                            np.asarray(p.group), np.asarray(p.tag), scene.total_volume())

    recs, states = [], {}
    t0 = time.perf_counter()
    for i in range(frames):
        recs.append(frame(sc))
        for k in ("x", "v"):
            states[f"{i}/{k}"] = np.asarray(getattr(sc.phys.bodies, k))
        save_scene(os.path.join(out_dir, f"frame{i}.npz"), sc)
    resynced = [frame(load_scene(os.path.join(out_dir, f"frame{k - 1}.npz"), sc.cfg))
                for k in range(1, frames)]
    np.savez(os.path.join(out_dir, "jax.npz"), **states,
             exact_caps=np.asarray(sc.cfg.fracture.exact_caps),
             records=json.dumps({"frames": recs, "resynced": resynced,
                                 "seconds": time.perf_counter() - t0}))


def compare(frames: int) -> dict:
    with tempfile.TemporaryDirectory(prefix="c10_") as out_dir:
        return _compare(frames, out_dir)


def _compare(frames: int, out_dir: str) -> dict:
    from surtr_tpu_torch.checkpoint import load_scene

    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX", JAX_PLATFORMS="cpu")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--jax-child",
                           str(frames), out_dir], env=env, stdout=subprocess.DEVNULL,
                          stderr=subprocess.PIPE, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the JAX child failed\n{proc.stderr[-4000:]}")
    jax_s = time.perf_counter() - t0
    ref = np.load(os.path.join(out_dir, "jax.npz"))
    jall = json.loads(str(ref["records"]))
    jrecs = jall["frames"]
    cfg = workload.INTERACTIVE_CFG
    cfg = dataclasses.replace(cfg, fracture=dataclasses.replace(
        cfg.fracture, exact_caps=bool(ref["exact_caps"])))
    sc = load_scene(os.path.join(out_dir, "init.npz"), cfg, device="cpu")
    prec, rows = [], []
    t0 = time.perf_counter()

    def on_frame(i, scene, img, met):
        p = scene.pieces
        prec.append(frame_record({k: np.asarray(v) for k, v in met.items()}, p.valid.numpy(),
                                 p.group.numpy(), p.tag.numpy(), scene.total_volume()))
        row = {"frame": i, "jax": jrecs[i], "port": prec[-1],
               "differ": differ(jrecs[i], prec[-1])}
        if i < STATE_FRAMES:
            dx = float(np.abs(scene.phys.bodies.x.numpy() - ref[f"{i}/x"]).max())
            dv = float(np.abs(scene.phys.bodies.v.numpy() - ref[f"{i}/v"]).max())
            row["state_dx_dv"] = [dx, dv]
            if not (dx <= X_ATOL and dv <= V_ATOL):
                row["differ"].append("state")
        rows.append(row)
        print(json.dumps(row), flush=True)

    workload.run_frames(sc, frames, on_frame)
    resynced = []
    for k in range(1, frames):
        start = load_scene(os.path.join(out_dir, f"frame{k - 1}.npz"), cfg, device="cpu")
        workload.run_frames(start, 1, lambda i, scene, img, met: resynced.append(frame_record(
            {m: np.asarray(v) for m, v in met.items()}, scene.pieces.valid.numpy(),
            scene.pieces.group.numpy(), scene.pieces.tag.numpy(), scene.total_volume())))
        row = {"frame": k, "jax": jall["resynced"][k - 1], "port": resynced[-1]}
        row["differ"] = differ(row["jax"], row["port"])
        print("resynced", json.dumps(row), flush=True)
        resynced[-1] = row
    port_s = time.perf_counter() - t0
    first = next((r["frame"] for r in rows if r["differ"]), None)
    summary = {"frames": frames, "first_frame_that_differs": first,
               "frames_that_differ": sum(bool(r["differ"]) for r in rows),
               "resynced_frames_that_differ": [r["frame"] for r in resynced if r["differ"]],
               "overflow_in_both": {k: [sum(r["jax"][k] > 0 for r in rows),
                                        sum(r["port"][k] > 0 for r in rows)]
                                    for k in OVERFLOWS},
               "jax_child_s": jax_s, "port_s": port_s}
    print("summary", json.dumps(summary), flush=True)
    return {"rows": rows, "resynced": resynced, "summary": summary}


def main():
    if sys.argv[1:2] == ["--jax-child"]:
        jax_child(int(sys.argv[2]), sys.argv[3])
        return
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=workload.FRAMES)
    ap.add_argument("--out", help="write the results as JSON here")
    args = ap.parse_args()
    res = compare(args.frames)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()
