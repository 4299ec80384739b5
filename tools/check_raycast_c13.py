"""Where the raycast ``t`` of ``Scene("blob")`` parts from the JAX package's
(ROADMAP C13).

    python3 tools/check_raycast_c13.py [--out DIR]

Runs on the CPU. A child process with ``--xla_cpu_max_isa=AVX`` (no FMA
contraction, as in the parity tests) builds the JAX package's
``Scene("blob")`` at tests/test_torch_concave.py's configuration, writes its
snapshot, and saves its piece planes, its world planes, the ray's ``s(o)``
per face and ``raycast``'s ``t``, and the inputs of ``build_scene``'s
body-frame plane offsets (the pieces' masses and centres of mass, the
bodies' centres recomputed eagerly and as its ``build_scene`` gave them).
The port then loads the snapshot and prints, for each stage, how many values differ from the JAX package's:
the rebuilt piece planes, the world planes, ``s(o)`` and ``t``; ``t`` again
with the JAX package's piece planes put in; the masses, centroids and
body centres of ``build_scene``; and the offset ``d + Σ n·x`` in five
summation orders from the bodies' x of the JAX package's ``build_scene``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def _jax_side(out):
    """Child-process side: the JAX package's Scene and its intermediates."""
    import jax
    import jax.numpy as jnp

    from test_torch_concave import SCENE_RAY, _scene_cfg

    from surtr_tpu.checkpoint import save_scene
    from surtr_tpu.ops.moments import inertia
    from surtr_tpu.physics import queries
    from surtr_tpu.scene import Scene

    sc = Scene("blob", _scene_cfg(True))
    save_scene(os.path.join(out, "init.npz"), sc)
    ph = sc.phys
    n, d = queries._world_planes(ph)
    o = jnp.asarray(SCENE_RAY[0], jnp.float32)
    dr = jnp.asarray(SCENE_RAY[1], jnp.float32)
    dr = dr / jnp.linalg.norm(dr)
    pidx, t = queries.raycast(ph, o, dr)
    pieces = sc.pieces
    B = pieces.P
    mass, com, _ = inertia(pieces.convex, density=sc.cfg.physics.density)
    mass = jnp.where(pieces.valid, mass, 0.0)
    gid = jnp.where(pieces.valid, pieces.group, B)
    seg = lambda x: jax.ops.segment_sum(x, gid, num_segments=B + 1)[:B]  # noqa: E731
    com_b = seg(com * mass[:, None]) / jnp.maximum(seg(mass), 1e-12)[:, None]
    np.savez(os.path.join(out, "jax.npz"), piece_planes=np.asarray(ph.piece_planes),
             n=np.asarray(n), d=np.asarray(d), so=np.asarray(jnp.sum(n * o, -1) + d),
             t=np.asarray(t), pidx=np.asarray(pidx), mass=np.asarray(mass),
             com=np.asarray(com), com_b=np.asarray(com_b),
             body_x=np.asarray(ph.bodies.x),
             shift=np.asarray(ph.bodies.x[jnp.clip(gid, 0, B - 1)]),
             planes=np.asarray(pieces.convex.planes))


def _differ(a, b) -> int:
    return int(np.sum(np.asarray(a) != np.asarray(b)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="directory for the snapshot (default: a temp dir)")
    args = ap.parse_args()
    out = args.out or tempfile.mkdtemp(prefix="c13_")
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--jax-child", out],
                          env=env, capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        sys.exit(proc.stderr[-4000:])
    r = np.load(os.path.join(out, "jax.npz"))

    import torch

    from test_torch_concave import SCENE_RAY, _scene_cfg

    from surtr_tpu_torch.checkpoint import load_scene
    from surtr_tpu_torch.ops.linalg import dot3
    from surtr_tpu_torch.ops.moments import inertia
    from surtr_tpu_torch.physics import queries
    from surtr_tpu_torch.physics.scene import _segment_sum
    from surtr_tpu_torch.scene import _host_ray

    cfg = _scene_cfg(False)
    sc = load_scene(os.path.join(out, "init.npz"), cfg, device="cpu")
    ph = sc.phys
    o, dr = _host_ray(*SCENE_RAY)
    n, d = queries._world_planes(ph)
    _, t = queries.raycast(ph, o, dr)
    print(f"rebuilt piece planes differing: {_differ(ph.piece_planes.numpy(), r['piece_planes'])}"
          f" of {r['piece_planes'].size}")
    print(f"world normals differing: {_differ(n.numpy(), r['n'])}, offsets: "
          f"{_differ(d.numpy(), r['d'])}, s(o): {_differ((dot3(n, o) + d).numpy(), r['so'])}")
    print(f"raycast t: port {float(t)!r}, JAX {float(r['t'])!r}")
    ph_j = dataclasses.replace(ph, piece_planes=torch.as_tensor(r["piece_planes"]))
    _, tj = queries.raycast(ph_j, o, dr)
    print(f"raycast t with the JAX package's piece planes: {float(tj)!r} "
          f"(bit for bit: {np.float32(tj.item()) == r['t']})")

    pieces = sc.pieces
    mass, com, _ = inertia(pieces.convex, density=cfg.physics.density)
    mass = torch.where(pieces.valid, mass, 0.0)
    B = pieces.P
    gid = torch.where(pieces.valid, pieces.group, B)
    com_b = (_segment_sum(com * mass[:, None], gid, B)
             / torch.clamp(_segment_sum(mass, gid, B), min=1e-12)[:, None])
    print(f"build_scene: masses differing {_differ(mass.numpy(), r['mass'])} of {B}, centroids "
          f"{_differ(com.numpy(), r['com'])} of {com.numel()}, body centres "
          f"{_differ(com_b.numpy(), r['com_b'])} of {com_b.numel()}")
    cm = r["com"] * r["mass"][:, None]
    g = np.asarray(gid)
    seq = np.zeros((B + 1, 3), np.float32)
    msum = np.zeros(B + 1, np.float32)
    for i in range(B):
        seq[g[i]] += cm[i]
        msum[g[i]] += r["mass"][i]
    seq_b = seq[:B] / np.maximum(msum[:B], np.float32(1e-12))[:, None]
    print(f"sequential float32 segment sums from the JAX package's moments: body centres "
          f"differing {_differ(seq_b, r['com_b'])} from its eager segment_sum, "
          f"{_differ(seq_b, r['body_x'])} from the bodies' x its build_scene gave")
    a = r["planes"][..., :3] * r["shift"][:, None, :]
    p = r["planes"][..., 3]
    want = r["piece_planes"]                  # rows sorted by owner, as ``order`` sorts
    orders = {
        "(a0 + a1) + a2": p + ((a[..., 0] + a[..., 1]) + a[..., 2]),
        "a0 + (a1 + a2)": p + (a[..., 0] + (a[..., 1] + a[..., 2])),
        "(a0 + a2) + a1": p + ((a[..., 0] + a[..., 2]) + a[..., 1]),
        "float64": p + a.astype(np.float64).sum(-1).astype(np.float32),
        "((d + a0) + a1) + a2": ((p + a[..., 0]) + a[..., 1]) + a[..., 2],
    }
    order = np.argsort(np.where(np.asarray(pieces.valid), np.asarray(pieces.group), B),
                       kind="stable")
    for name, v in orders.items():
        print(f"offset order {name}: {_differ(v[order], want[..., 3])} of {v.size} differ")


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--jax-child":
        _jax_side(sys.argv[2])
    else:
        main()
