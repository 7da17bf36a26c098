"""Exact Hungarian assignment (LSAP) on the card, batched (port of
svol_tpu/ops/hungarian.py).

Rectangular problems (fewer real targets than queries) are made square by
giving the invalid target columns one constant cost just above the largest
valid cost: dummy columns all cost the same, so the optimum restricted to
the real columns equals the rectangular LSAP optimum scipy returns. The pad
stays on the scale of the real costs; a huge pad (1e6) would erase 1e-3
cost differences in float32.
"""
from __future__ import annotations

import torch

from svol_tpu_torch.ops.kernels.lsap import lsap, solve_dense_reference

__all__ = ["hungarian", "masked_cost_matrix", "solve_dense_reference"]


def masked_cost_matrix(cost: torch.Tensor, col_valid: torch.Tensor) -> torch.Tensor:
    """cost (..., n, n), col_valid (..., n) bool: invalid columns take a
    per-problem constant, max valid entry + 1 (1 if none is valid)."""
    valid = col_valid[..., None, :]
    # scalars made on the device (a copy from the host would synchronize)
    masked = torch.where(valid, cost, cost.new_full((), -torch.inf))
    big = masked.amax(dim=(-2, -1), keepdim=True)
    big = torch.where(torch.isfinite(big), big, cost.new_zeros(())) + 1.0
    return torch.where(valid, cost, big)


def hungarian(cost: torch.Tensor) -> torch.Tensor:
    """Batched exact LSAP: cost (..., R, C) with R <= C -> col4row (..., R)
    int32. CPU tensors take the plain solver; CUDA tensors launch the LSAP
    kernel or raise (no host fallback)."""
    batch = cost.shape[:-2]
    r, c = cost.shape[-2:]
    out = lsap(cost.reshape(-1, r, c).float().contiguous())
    return out.reshape(batch + (r,))
