"""plainref: a frozen copy of the plain PyTorch path of ``surtr_tpu_torch``
(commit 80b652d), the benchmark's reference.

Every module is the port's, with its imports renamed, so that a later change
to the port cannot move the yardstick. It runs on CPU tensors only, where each
kernel wrapper takes its plain version; ``_build`` is a stub, so no kernel is
ever built or launched from here. It imports neither the port nor JAX."""

import torch

from plainref.config import FractureConfig, PhysicsConfig, RenderConfig, SceneConfig
from plainref.types import ConvexPoly, RigidState, TriSoup

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
