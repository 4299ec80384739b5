"""surtr_tpu_torch — the PyTorch + CUDA port of surtr_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout and names. Plain tensor code is PyTorch;
every Pallas kernel of the ported slice is a hand-written CUDA kernel under
``csrc/``, built on first use (``_build.py``). Each kernel wrapper runs its
plain PyTorch version for CPU tensors and launches the kernel (or raises)
for CUDA tensors.

The package never imports JAX.
"""

import torch

from surtr_tpu_torch.config import FractureConfig, PhysicsConfig, RenderConfig, SceneConfig
from surtr_tpu_torch.types import ConvexPoly, RigidState, TriSoup

# The reference pins precision=HIGHEST: one-hot selections and support maxima
# rely on full-f32 products, so TF32 stays off everywhere.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = [
    "ConvexPoly",
    "FractureConfig",
    "PhysicsConfig",
    "RenderConfig",
    "SceneConfig",
    "TriSoup",
    "RigidState",
]
