"""Connected components of triangle soups (counterpart of
``surtr_tpu/ops/labels.py``, the "jump" scheme).

Triangles sharing a tol-quantized corner position are adjacent; labels are
closed by min-label relaxation plus pointer jumping, a bounded number of
rounds. Label = min triangle index of the component; invalid triangles get
T. Plain PyTorch; the kernel is in ``labels_cuda.py``.
``adjacency_components`` labels the components of a boolean graph (the
contact split of compounds).
"""

from __future__ import annotations

import torch


def label_rounds(T: int, iters: int | None) -> int:
    """Relax + jump rounds: ceil(log2 T), capped by ``iters``, at least 1."""
    rounds = max(1, (max(T - 1, 1)).bit_length())
    if iters is not None:
        rounds = max(1, min(rounds, iters))
    return rounds


def quantize(corners: torch.Tensor, tol: float) -> torch.Tensor:
    """round-half-even(corners / tol) as int32 (jnp.round semantics)."""
    return torch.round(corners / tol).to(torch.int32)


def tri_soup_components(corners: torch.Tensor, tri_valid: torch.Tensor,
                        iters: int | None = None, tol: float = 1e-5) -> torch.Tensor:
    """corners (..., T, 3, 3), tri_valid (..., T) → (..., T) int32 labels."""
    T = corners.shape[-3]
    q = quantize(corners, tol)
    adj = torch.zeros(corners.shape[:-3] + (T, T), dtype=torch.bool, device=corners.device)
    for a in range(3):
        for b in range(3):
            adj |= torch.all(q[..., :, None, a, :] == q[..., None, :, b, :], dim=-1)
    adj &= tri_valid[..., :, None] & tri_valid[..., None, :]
    idx = torch.arange(T, dtype=torch.int32, device=corners.device)
    big = torch.tensor(T, dtype=torch.int32, device=corners.device)
    lab = torch.where(tri_valid, idx, big)
    for _ in range(label_rounds(T, iters)):
        nb = torch.amin(torch.where(adj, lab[..., None, :], big), dim=-1)
        lab = torch.minimum(lab, nb)
        lab = torch.minimum(lab, torch.gather(lab, -1, torch.clamp(lab, 0, T - 1).long()))
    return torch.where(tri_valid, lab, big)


def adjacency_components(adj: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Component label per node of a boolean adjacency matrix (N, N) (need
    not be symmetric): ceil(log2 N) squarings of the reachability relation
    as float32 matrix products (0/1 entries, sums up to N: exact), then the
    smallest reachable node index. Invalid nodes get N. Returns (N,) int32."""
    N = adj.shape[0]
    dev = adj.device
    a = (adj | adj.T) & valid[:, None] & valid[None, :]
    r = (a | torch.eye(N, dtype=torch.bool, device=dev)).to(torch.float32)
    for _ in range(max(1, (N - 1).bit_length())):
        r = torch.clamp(r + r @ r, max=1.0)
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    label = torch.amin(torch.where(r > 0.5, idx[None, :], N), dim=1)
    return torch.where(valid, label, N).to(torch.int32)
