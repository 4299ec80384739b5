"""The port's main-path workload: the 1k-seed decomposition of the cube at
``bench.py``'s ``bench_decomposition_1k`` configuration (bench.py:70-92).

One owner for the configuration, the seeds and the inputs that
``chip_smoke.py`` and ``tools/profile_torch_prepare.py`` both drive.
"""

from __future__ import annotations

import subprocess

import torch

from surtr_tpu_torch.config import FractureConfig
from surtr_tpu_torch.fracture import pipeline
from surtr_tpu_torch.fracture.pattern import radial_seeds, uniform_seeds
from surtr_tpu_torch.io.models import get_model, sphere_point_cloud

SEED = 46354
BENCH_CFG = FractureConfig(
    initial_decompose_cell_cnt=1024,
    max_pieces=1024,
    max_faces=26,
    max_face_verts=16,
    max_piece_tris=64,
    voronoi_neighbors=48,
    voronoi_prefix=24,
    partial_pattern_cell_cnt=8,
    general_pattern_cell_cnt=8,
    exact_caps=False,
)


def cube_inputs(device):
    """``prepare_fracture``'s model arguments for the cube on ``device``."""
    v, f = get_model("cube")
    return (
        torch.as_tensor(v, device=device),
        torch.ones(len(v), dtype=torch.bool, device=device),
        torch.as_tensor(v[f], device=device),
        torch.ones(len(f), dtype=torch.bool, device=device),
        torch.as_tensor(sphere_point_cloud(), device=device),
    )


def bench_seeds(cfg: FractureConfig = BENCH_CFG, seed: int = SEED):
    """Decomposition, partial-pattern and general-pattern seeds (host tensors)."""
    g = torch.Generator().manual_seed(seed)
    return (
        uniform_seeds(g, cfg.initial_decompose_cell_cnt),
        radial_seeds(g, cfg.partial_pattern_cell_cnt, cfg.partial_pattern_dist),
        radial_seeds(g, cfg.general_pattern_cell_cnt, cfg.general_pattern_dist),
    )


def run_prepare(device, cfg: FractureConfig = BENCH_CFG):
    """One ``prepare_fracture`` event of the cube on ``device``."""
    return pipeline.prepare_fracture(*cube_inputs(device), cfg, *bench_seeds(cfg))


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, which
    every time measured on it is reported beside."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    out = smi.stdout.strip()
    return out.splitlines()[0] if smi.returncode == 0 and out else "unknown"
