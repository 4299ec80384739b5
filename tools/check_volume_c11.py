"""Where a decomposition's volume goes: the port's pieces against the
source mesh and the float64 oracle (ROADMAP C11).

    python3 tools/check_volume_c11.py [--out FILE.json] [--cases NAME ...] [--jax]

Runs on the CPU (every kernel's plain version). Per case, one
``prepare_fracture`` of the port, then:

* the pieces' total convex volume and the total signed volume of their
  capped meshes, beside the source mesh's volume;
* ``mesh_tris_dropped`` split by cause: the mesh clip (capacity ``Tp``
  per cell) and the caps (``_finish_pieces``' cap drops: exact-cap record,
  pool and row capacity, and cap rows that find no free mesh slot);
* the float64 oracle (``surtr_tpu.oracle``, the reference's
  ClipPolyhedron): the source mesh clipped by each Voronoi cell's planes,
  whose volumes sum to the mesh's when the cells tile the model, and the
  cells holding material whose ACH ∩ cell fold came out empty (with the
  ACH's live faces beside the face capacity F).

The cases: the sphere at the 64-cell configuration of
``tests/test_torch_prepare.py`` and at the 1k bench configuration (F = 26,
S = 16, Tp = 64), each again with Tp = 256 and with F = 96, S = 32, and
the torus at BASELINE config 1 (``workload.MODEL_1K_CFG``, F = 96, S = 32,
Tp = 128) and at Tp = 512, and config 1 at its model's scale
(``torus10k_tp128``): the 10,000-triangle torus of ``chip_smoke.py``'s
phase 29, which the tool writes once as OBJ text
(``workload.model_scale_obj_text``) and each package reads back with its
own ``io.obj.load_obj``.

With ``--jax``, each chosen case in ``JAX_CASES`` also runs through the JAX
package, compiled on the CPU in a child process with
``--xla_cpu_max_isa=AVX`` (no FMA contraction, as in the parity tests),
all children in parallel. Both packages then start from the JAX package's
seeds (``PRNGKey(46354)``), and the tool prints each package's
``piece_cnt``, ``mesh_tris_dropped`` (and the caps' share of it),
``total_volume`` and capped-mesh volume, and the slots whose ``valid``
differs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from surtr_tpu_torch import workload  # noqa: E402
from surtr_tpu_torch.config import FractureConfig  # noqa: E402
from surtr_tpu_torch.fracture import pipeline  # noqa: E402
from surtr_tpu_torch.io.models import get_model  # noqa: E402
from surtr_tpu_torch.io.obj import load_obj  # noqa: E402
from surtr_tpu_torch.ops.moments import moments  # noqa: E402

SPHERE64 = FractureConfig(initial_decompose_cell_cnt=64, max_pieces=64, max_faces=26,
                          max_face_verts=16, max_piece_tris=64, voronoi_neighbors=31,
                          voronoi_prefix=8, partial_pattern_cell_cnt=8,
                          general_pattern_cell_cnt=8, exact_caps=False)
CASES = {
    "sphere64_tp64": ("sphere", SPHERE64),
    "sphere64_tp256": ("sphere", dataclasses.replace(SPHERE64, max_piece_tris=256)),
    "sphere64_f96": ("sphere", dataclasses.replace(SPHERE64, max_faces=96, max_face_verts=32)),
    "sphere1k_tp64": ("sphere", workload.BENCH_CFG),
    "sphere1k_tp256": ("sphere", dataclasses.replace(workload.BENCH_CFG, max_piece_tris=256)),
    "sphere1k_f96": ("sphere", dataclasses.replace(workload.BENCH_CFG, max_faces=96,
                                                   max_face_verts=32)),
    "torus1k_tp128": ("torus", workload.MODEL_1K_CFG),
    "torus1k_tp512": ("torus", dataclasses.replace(workload.MODEL_1K_CFG, max_piece_tris=512)),
    "torus10k_tp128": ("torus10k", workload.MODEL_1K_CFG),
}

# Cases also run through the JAX package with ``--jax``.
JAX_CASES = ("torus1k_tp128", "sphere1k_tp64", "torus10k_tp128")
JAX_KEY = 46354

# Models read from OBJ text that the tool writes once (``write_obj_models``).
OBJ_MODELS = {"torus10k": workload.model_scale_obj_text}
OBJ_PATHS: dict[str, str] = {}


def write_obj_models(directory):
    for name, text in OBJ_MODELS.items():
        OBJ_PATHS[name] = os.path.join(directory, f"{name}.obj")
        with open(OBJ_PATHS[name], "w") as fh:
            fh.write(text())


def load_model(model):
    """(verts, tris) of a procedural model, or of an OBJ model read back
    from the file the tool wrote."""
    return load_obj(OBJ_PATHS[model]) if model in OBJ_PATHS else get_model(model)


def mesh_volume(tris: np.ndarray) -> float:
    """Signed volume of a triangle soup (T, 3, 3), float64."""
    t = tris.astype(np.float64)
    return float(np.einsum("ij,ij->i", t[:, 0], np.cross(t[:, 1], t[:, 2])).sum() / 6.0)


def oracle_cell_volumes(model, planes, pmask) -> np.ndarray:
    """Float64 volume of the source mesh clipped by each cell's live planes."""
    from surtr_tpu.oracle import clip_polyhedron, moments as omoments, polyhedron_from_mesh

    v, f = load_model(model)
    poly = polyhedron_from_mesh(v.astype(np.float64), f)
    out = np.zeros(planes.shape[0])
    for c in range(planes.shape[0]):
        clipped = clip_polyhedron(poly, planes[c][pmask[c]].astype(np.float64))
        out[c] = omoments(clipped)[0] if clipped else 0.0
    return out


def run_case(model, cfg):
    """One port decomposition with its cell planes and drop split captured."""
    got = {}
    mesh = load_model(model)
    cells, finish, clip = (pipeline._cell_plane_sets, pipeline._finish_pieces,
                           pipeline.clip_planes_batch)

    def rec_clip(*a, **k):
        out = clip(*a, **k)
        if "ach_faces" not in got:        # the first fold is the ACH's
            got["ach_faces"] = int(out.face_mask().sum())
        return out

    def rec_cells(*a, **k):
        got["cells"] = cells(*a, **k)
        return got["cells"]

    def rec_finish(*a, **k):
        got["empty"] = a[0].is_empty()[:cfg.initial_decompose_cell_cnt].numpy()
        out = finish(*a, **k)
        got["cap_drop"] = int(out[4])
        got["candidates"] = int(out[3].shape[0])
        return out

    pipeline._cell_plane_sets, pipeline._finish_pieces = rec_cells, rec_finish
    pipeline.clip_planes_batch = rec_clip
    try:
        t0 = time.perf_counter()
        pieces, _, met = workload.run_prepare("cpu", cfg, mesh)
        secs = time.perf_counter() - t0
    finally:
        pipeline._cell_plane_sets, pipeline._finish_pieces = cells, finish
        pipeline.clip_planes_batch = clip
    valid = pieces.valid
    conv_vol = float(torch.where(valid, moments(pieces.convex)[0], 0.0).double().sum())
    tris = pieces.mesh[pieces.mesh_valid & valid[:, None]].numpy()
    planes, pmask = (t.numpy() for t in got["cells"])
    v, f = mesh
    src = mesh_volume(v[f])
    t0 = time.perf_counter()
    ocells = oracle_cell_volumes(model, planes, pmask)
    drop = int(met["mesh_tris_dropped"])
    return {
        "model": model, "cells": cfg.initial_decompose_cell_cnt, "Tp": cfg.max_piece_tris,
        "exact_caps": cfg.exact_caps, "seconds": secs, "oracle_seconds": time.perf_counter() - t0,
        "piece_cnt": int(met["piece_cnt"]), "candidates": got["candidates"],
        "mesh_volume": src, "convex_volume": conv_vol,
        "convex_over_mesh": conv_vol / src,
        "capped_mesh_volume": mesh_volume(tris), "capped_mesh_over_mesh": mesh_volume(tris) / src,
        "mesh_tris_dropped": drop, "dropped_by_caps": got["cap_drop"],
        "dropped_by_mesh_clip": drop - got["cap_drop"],
        "oracle_cells_volume": float(ocells.sum()),
        "oracle_over_mesh": float(ocells.sum()) / src,
        "oracle_cells_with_material": int((ocells > 1e-9).sum()),
        # Cells whose mesh part the oracle finds non-empty but whose
        # ACH ∩ cell fold came out empty, and the material they hold.
        "material_cells_emptied": int(((ocells > 1e-9) & got["empty"]).sum()),
        "material_in_emptied_cells": float(ocells[got["empty"]].sum()),
        "ach_faces": got["ach_faces"], "F": cfg.max_faces,
    }


def _stats(valid, mesh, mesh_valid, met) -> dict:
    """A decomposition's counts and volumes (numpy arrays in)."""
    return {"piece_cnt": int(met["piece_cnt"]), "mesh_tris_dropped": int(met["mesh_tris_dropped"]),
            "ich_face_cnt": int(met["ich_face_cnt"]), "total_volume": float(met["total_volume"]),
            "capped_mesh_volume": mesh_volume(mesh[mesh_valid & valid[:, None]])}


def jax_child(model, cfg_json, out):
    """Child-process side of ``--jax``: the JAX package's decomposition of
    ``model`` (a procedural name, or an .obj path read with its own
    ``load_obj``) at the configuration ``cfg_json`` (FractureConfig
    fields), its seeds and its results, saved to ``out`` (.npz)."""
    import jax
    import jax.numpy as jnp

    from surtr_tpu.config import FractureConfig as JaxFractureConfig
    from surtr_tpu.fracture import pipeline as jax_pipeline
    from surtr_tpu.fracture.pattern import radial_seeds, uniform_seeds
    from surtr_tpu.io.models import get_model as jax_get_model, sphere_point_cloud
    from surtr_tpu.io.obj import load_obj as jax_load_obj

    cfg = JaxFractureConfig(**json.loads(cfg_json))
    v, f = jax_load_obj(model) if model.endswith(".obj") else jax_get_model(model)
    key = jax.random.PRNGKey(JAX_KEY)
    # The caps' drops, read from _finish_pieces inside the compiled event.
    got = {}
    finish = jax_pipeline._finish_pieces

    def rec_finish(*a, **k):
        out = finish(*a, **k)
        jax.debug.callback(lambda x: got.__setitem__("cap_drop", int(x)), out[4])
        return out

    jax_pipeline._finish_pieces = rec_finish
    t0 = time.perf_counter()
    pieces, _, met = jax_pipeline.prepare_fracture(
        jnp.asarray(v), jnp.ones(len(v), bool), jnp.asarray(v[f]), jnp.ones(len(f), bool),
        jnp.asarray(sphere_point_cloud()), key, cfg)
    valid = np.asarray(pieces.valid)
    secs = time.perf_counter() - t0
    k0, k1, k2 = jax.random.split(key, 3)
    np.savez(out, seeds=np.asarray(uniform_seeds(k0, cfg.initial_decompose_cell_cnt)),
             pseeds=np.asarray(radial_seeds(k1, cfg.partial_pattern_cell_cnt,
                                            cfg.partial_pattern_dist)),
             gseeds=np.asarray(radial_seeds(k2, cfg.general_pattern_cell_cnt,
                                            cfg.general_pattern_dist)),
             valid=valid, verts=v, tris=f,
             stats=json.dumps({**_stats(valid, np.asarray(pieces.mesh),
                                        np.asarray(pieces.mesh_valid), met),
                               "dropped_by_caps": got["cap_drop"], "seconds": secs}))


def jax_compare(names) -> dict:
    """``--jax``: each case through the JAX package (AVX-only children, in
    parallel) and through the port from the JAX package's seeds."""
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX", JAX_PLATFORMS="cpu")
    tmp = tempfile.mkdtemp(prefix="c11_jax_")
    procs = {}
    for name in names:
        model, cfg = CASES[name]
        procs[name] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--jax-child", OBJ_PATHS.get(model, model),
             json.dumps(dataclasses.asdict(cfg)), os.path.join(tmp, f"{name}.npz")],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    res = {}
    try:
        for name, proc in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{name}: the JAX child failed\n{err[-4000:]}")
            ref = np.load(os.path.join(tmp, f"{name}.npz"))
            model, cfg = CASES[name]
            v, f = load_model(model)
            same_mesh = (np.array_equal(v.view(np.uint32), ref["verts"].view(np.uint32))
                         and np.array_equal(f, ref["tris"]))
            got = {}
            finish = pipeline._finish_pieces

            def rec_finish(*a, **k):
                out = finish(*a, **k)
                got["cap_drop"] = int(out[4])
                return out

            pipeline._finish_pieces = rec_finish
            try:
                t0 = time.perf_counter()
                pieces, _, met = pipeline.prepare_fracture(
                    *workload.model_inputs((v, f), "cpu"), cfg,
                    *(torch.as_tensor(ref[k]) for k in ("seeds", "pseeds", "gseeds")))
                secs = time.perf_counter() - t0
            finally:
                pipeline._finish_pieces = finish
            port = {**_stats(pieces.valid.numpy(), pieces.mesh.numpy(),
                             pieces.mesh_valid.numpy(), met),
                    "dropped_by_caps": got["cap_drop"], "seconds": secs}
            res[name] = {"jax": json.loads(str(ref["stats"])), "port": port,
                         "same_mesh_bits": same_mesh,
                         "valid_slots_differ": int((pieces.valid.numpy() != ref["valid"]).sum())}
            print(f"{name} (JAX seeds)", json.dumps(res[name]), flush=True)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def main():
    if sys.argv[1:2] == ["--jax-child"]:
        jax_child(*sys.argv[2:5])
        return
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the results as JSON here")
    ap.add_argument("--cases", nargs="*", default=list(CASES), choices=list(CASES))
    ap.add_argument("--jax", action="store_true",
                    help="also run the chosen JAX_CASES through the JAX package")
    args = ap.parse_args()
    res = {}
    with tempfile.TemporaryDirectory(prefix="c11_obj_") as obj_dir:
        write_obj_models(obj_dir)
        if args.jax:
            res["jax"] = jax_compare([n for n in args.cases if n in JAX_CASES])
        for name in args.cases:
            res[name] = run_case(*CASES[name])
            print(name, json.dumps(res[name]), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()
