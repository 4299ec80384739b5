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

from plainref.ops.linalg import div_rn


def label_rounds(T: int, iters: int | None) -> int:
    """Relax + jump rounds: ceil(log2 T), capped by ``iters``, at least 1."""
    rounds = max(1, (max(T - 1, 1)).bit_length())
    if iters is not None:
        rounds = max(1, min(rounds, iters))
    return rounds


def quantize(corners: torch.Tensor, tol: float) -> torch.Tensor:
    """round-half-even(corners / tol) as int32 (jnp.round semantics), the
    division a true one on every device (``div_rn``: the card multiplies by
    the rounded reciprocal of a Python divisor, which moves a corner that
    sits on a rounding boundary)."""
    return torch.round(div_rn(corners, tol)).to(torch.int32)


def _adjacency(corners: torch.Tensor, tri_valid: torch.Tensor, tol: float) -> torch.Tensor:
    """(..., T, T) bool: both valid and some corner pair equal after
    quantization."""
    T = corners.shape[-3]
    q = quantize(corners, tol)
    adj = torch.zeros(corners.shape[:-3] + (T, T), dtype=torch.bool, device=corners.device)
    for a in range(3):
        for b in range(3):
            adj |= torch.all(q[..., :, None, a, :] == q[..., None, :, b, :], dim=-1)
    return adj & tri_valid[..., :, None] & tri_valid[..., None, :]


def _round(lab: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """One round: min-label relaxation, then the pointer jump."""
    T = lab.shape[-1]
    big = torch.tensor(T, dtype=torch.int32, device=lab.device)
    nb = torch.amin(torch.where(adj, lab[..., None, :], big), dim=-1)
    lab = torch.minimum(lab, nb)
    return torch.minimum(lab, torch.gather(lab, -1, torch.clamp(lab, 0, T - 1).long()))


def _start(tri_valid: torch.Tensor) -> torch.Tensor:
    T = tri_valid.shape[-1]
    idx = torch.arange(T, dtype=torch.int32, device=tri_valid.device)
    return torch.where(tri_valid, idx, torch.tensor(T, dtype=torch.int32, device=idx.device))


def tri_soup_components(corners: torch.Tensor, tri_valid: torch.Tensor,
                        iters: int | None = None, tol: float = 1e-5) -> torch.Tensor:
    """corners (..., T, 3, 3), tri_valid (..., T) → (..., T) int32 labels."""
    T = corners.shape[-3]
    adj = _adjacency(corners, tri_valid, tol)
    lab = _start(tri_valid)
    for _ in range(label_rounds(T, iters)):
        lab = _round(lab, adj)
    return torch.where(tri_valid, lab, T)


def label_rounds_run(corners: torch.Tensor, tri_valid: torch.Tensor,
                     iters: int | None = None, tol: float = 1e-5) -> torch.Tensor:
    """(...,) int32: the rounds a soup's labels take when the loop stops
    after the first round that changes no label (as kernel B3 does), at
    most ``label_rounds(T, iters)``; 0 for a soup with no valid triangle.
    A round is a function of the labels alone, so stopping there returns
    the labels of all the rounds."""
    T = corners.shape[-3]
    adj = _adjacency(corners, tri_valid, tol)
    lab = _start(tri_valid)
    run = torch.zeros(tri_valid.shape[:-1], dtype=torch.int32, device=corners.device)
    live = torch.any(tri_valid, dim=-1)
    for _ in range(label_rounds(T, iters)):
        run += live.to(torch.int32)
        nxt = _round(lab, adj)
        live &= torch.any((nxt != lab) & tri_valid, dim=-1)
        lab = nxt
    return run


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
