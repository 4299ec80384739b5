"""CLI (counterpart of ``surtr_tpu/__main__.py``): the headless counterpart of
the reference's argument surface (SurtrArgument: modelIndex, shadowMapSize,
fullscreen, width/height) plus scripted impacts, on ``--device`` (``cuda``
unless ``--device cpu`` is given).

Examples:
  python -m surtr_tpu_torch --model cube --steps 240 \\
      --impact 0,4.5,-10:0,0,1@60 --frames out --size 512
  python -m surtr_tpu_torch --model torus --steps 120 --save state.npz
  SURTR_REFERENCE_ROOT=<reference checkout> python -m surtr_tpu_torch --model pumpkin
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def parse_impact(spec: str):
    """'ox,oy,oz:dx,dy,dz@step' → (origin, direction, step)."""
    loc, step = spec.split("@") if "@" in spec else (spec, "0")
    o, d = loc.split(":")
    origin = tuple(float(x) for x in o.split(","))
    direction = tuple(float(x) for x in d.split(","))
    return origin, direction, int(step)


def camera_eye(spec: str, step: int, total_steps: int):
    """Eye position at ``step`` along a --camera path ('fixed',
    'orbit[:R,H,PERIOD_S]', 'fly:X0,Y0,Z0:X1,Y1,Z1') — the headless
    counterpart of the reference's fly/orbit camera."""
    import numpy as np

    if spec.startswith("orbit"):
        r, h, period = 11.0, 6.5, 6.0
        if ":" in spec:
            r, h, period = (float(v) for v in spec.split(":")[1].split(","))
        ang = 2.0 * np.pi * (step / 120.0) / period
        return (r * np.cos(ang), h, r * np.sin(ang))
    if spec.startswith("fly:"):
        _, a, b = spec.split(":")
        p0 = np.asarray([float(v) for v in a.split(",")])
        p1 = np.asarray([float(v) for v in b.split(",")])
        t = step / max(total_steps - 1, 1)
        return tuple(p0 + (p1 - p0) * t)
    return (8.0, 6.0, 8.0)


def save_ppm(path, img):
    """An (H, W, 3) image in [0, 1] (a tensor on any device, or an array)
    as a binary PPM."""
    import numpy as np

    if hasattr(img, "cpu"):
        img = img.cpu()
    a = (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (a.shape[1], a.shape[0]))
        f.write(a.tobytes())


def main(argv=None):
    p = argparse.ArgumentParser(prog="surtr_tpu_torch")
    p.add_argument("--model", default="cube",
                   help="cube|sphere|torus|blob or a reference model name")
    p.add_argument("--steps", type=int, default=240)
    p.add_argument("--impact", action="append", default=[],
                   help="ox,oy,oz:dx,dy,dz@step (repeatable)")
    p.add_argument("--seed", type=int, default=46354)
    p.add_argument("--radius", type=float, default=1.0)
    p.add_argument("--no-partial", action="store_true")
    p.add_argument("--no-radial", action="store_true")
    p.add_argument("--size", type=int, default=0,
                   help="render frames at SIZE x SIZE (0 = no rendering)")
    p.add_argument("--shadow", type=int, default=1024)
    p.add_argument("--frames", default="",
                   help="directory for rendered .ppm frames (every 10 steps)")
    p.add_argument("--camera", default="fixed",
                   help="camera path for frame dumps: 'fixed', "
                        "'orbit[:RADIUS,HEIGHT,PERIOD_S]' (circle the scene "
                        "center, the reference's orbit camera), or "
                        "'fly:X0,Y0,Z0:X1,Y1,Z1' (linear eye path over the "
                        "run)")
    p.add_argument("--save", default="", help="final state snapshot (.npz)")
    p.add_argument("--trajectory", default="",
                   help="write body trajectories to .npz")
    p.add_argument("--preset", default="full", choices=("full", "tiny"),
                   help="'tiny' = small static shapes (smoke tests / previews)")
    p.add_argument("--device", default="cuda",
                   help="torch device the scene runs on ('cuda', 'cuda:1', 'cpu')")
    args = p.parse_args(argv)

    import numpy as np

    from surtr_tpu_torch.config import FractureConfig, RenderConfig, SceneConfig
    from surtr_tpu_torch.scene import Scene

    tiny = dict(
        initial_decompose_cell_cnt=8,
        max_pieces=64,
        max_active_pieces=4,
        max_piece_tris=96,
        partial_pattern_cell_cnt=16,
        general_pattern_cell_cnt=8,
        voronoi_neighbors=7,
    ) if args.preset == "tiny" else {}
    fcfg = FractureConfig(
        seed=args.seed,
        impact_radius=args.radius,
        partial_fracture=not args.no_partial,
        radial_mode=not args.no_radial,
        **tiny,
    )
    rcfg = RenderConfig(
        width=args.size or 512, height=args.size or 512, shadow_size=args.shadow
    )
    cfg = SceneConfig(fracture=fcfg, render=rcfg)

    t0 = time.time()
    sc = Scene(args.model, cfg, device=args.device)
    print(
        f"prepared {args.model}: {sc.num_pieces()} pieces, "
        f"volume {sc.total_volume():.3f} ({time.time()-t0:.1f}s)",
        file=sys.stderr,
    )

    impacts = sorted((parse_impact(s) for s in args.impact), key=lambda x: x[2])
    traj = []
    if args.frames:
        os.makedirs(args.frames, exist_ok=True)

    frame_id = 0
    for step in range(args.steps):
        while impacts and impacts[0][2] == step:
            origin, direction, _ = impacts.pop(0)
            out = sc.fire_impact(origin, direction)
            print(
                f"step {step}: impact → "
                f"{len(out.get('targets', []))} bodies, "
                f"{sc.num_pieces()} pieces / {sc.num_bodies()} compounds",
                file=sys.stderr,
            )
        sc.step(1)
        if args.trajectory:
            traj.append(sc.phys.bodies.x.cpu().numpy())
        if args.frames and args.size and step % 10 == 0:
            save_ppm(
                os.path.join(args.frames, f"f{frame_id:04d}.ppm"),
                sc.render(eye=camera_eye(args.camera, step, args.steps)),
            )
            frame_id += 1

    if args.save:
        from surtr_tpu_torch.checkpoint import save_scene

        save_scene(args.save, sc)
    if args.trajectory:
        np.savez_compressed(args.trajectory, x=np.stack(traj))

    print(
        json.dumps(
            {
                "model": args.model,
                "steps": args.steps,
                "pieces": sc.num_pieces(),
                "bodies": sc.num_bodies(),
                "volume": round(sc.total_volume(), 4),
                "sim_time": round(sc.time, 4),
                "wall_s": round(time.time() - t0, 1),
            }
        )
    )


if __name__ == "__main__":
    main()
