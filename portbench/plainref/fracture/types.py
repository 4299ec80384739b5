"""Fracture-pipeline state (counterpart of ``surtr_tpu/fracture/types.py``).

``PieceSet`` is the flat, padded pool of pieces (compound membership is the
``group`` label); ``FractureContext`` the per-model state computed once by
``prepare_fracture``.
"""

from __future__ import annotations

import dataclasses

import torch

from plainref.types import ConvexPoly, empty_poly


@dataclasses.dataclass
class PieceSet:
    """convex: ConvexPoly batch (P,); mesh (P, T, 3, 3) visual triangles;
    mesh_valid (P, T); valid (P,); group (P,) i32 compound id; tag (P,) i32
    caller payload (-1 = freshly cut)."""

    convex: ConvexPoly
    mesh: torch.Tensor
    mesh_valid: torch.Tensor
    valid: torch.Tensor
    group: torch.Tensor
    tag: torch.Tensor

    @property
    def P(self) -> int:
        return self.valid.shape[-1]

    @property
    def T(self) -> int:
        return self.mesh.shape[-3]

    def num_pieces(self):
        return self.valid.sum()

    def num_groups(self):
        """Number of distinct group ids among the valid pieces."""
        sg = torch.sort(torch.where(self.valid, self.group, -1)).values
        new = torch.ones_like(self.valid)
        new[1:] = sg[1:] != sg[:-1]
        return (new & (sg >= 0)).sum()


def empty_piece_set(P: int, T: int, F: int, S: int, dtype=torch.float32,
                    device=None) -> PieceSet:
    return PieceSet(
        convex=empty_poly(F, S, (P,), dtype, device),
        mesh=torch.zeros((P, T, 3, 3), dtype=dtype, device=device),
        mesh_valid=torch.zeros((P, T), dtype=torch.bool, device=device),
        valid=torch.zeros((P,), dtype=torch.bool, device=device),
        group=torch.full((P,), -1, dtype=torch.int32, device=device),
        tag=torch.full((P,), -1, dtype=torch.int32, device=device),
    )


@dataclasses.dataclass
class FractureContext:
    """Bounding box, max axis scale, the two impact patterns in unit space
    and the 42-point impact-sphere cloud."""

    bb_center: torch.Tensor
    bb_min: torch.Tensor
    bb_max: torch.Tensor
    max_axis_scale: torch.Tensor
    partial_pattern: ConvexPoly
    general_pattern: ConvexPoly
    sphere_cloud: torch.Tensor
