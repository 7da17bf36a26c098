"""Sine positional embedding (port of svol_tpu/models/positional.py)."""
from __future__ import annotations

import math

import torch
from torch import nn


class PositionEmbeddingSine(nn.Module):
    """1-D sine embedding over the cumulative sum of the validity mask,
    normalized to [0, 2*pi] (eps 1e-6), temperature 10000. Produces
    (B, L, num_pos_feats) in f32; sin and cos interleave by channel (even
    channels sin, odd cos)."""

    def __init__(self, num_pos_feats: int = 64):
        super().__init__()
        self.num_pos_feats = num_pos_feats

    def forward(self, mask: torch.Tensor) -> torch.Tensor:
        # mask: (B, L), True = valid
        x_embed = torch.cumsum(mask.float(), dim=1)
        x_embed = x_embed / (x_embed[:, -1:] + 1e-6) * (2 * math.pi)
        dim_t = torch.arange(self.num_pos_feats, dtype=torch.float32,
                             device=mask.device)
        dim_t = 10000.0 ** (2 * torch.floor(dim_t / 2) / self.num_pos_feats)
        pos_x = x_embed[:, :, None] / dim_t  # (B, L, F)
        B, L = x_embed.shape
        return torch.stack(
            [torch.sin(pos_x[:, :, 0::2]), torch.cos(pos_x[:, :, 1::2])], dim=3
        ).reshape(B, L, -1)


def make_position_embedding(kind: str, hidden_dim: int) -> nn.Module:
    """The ``sine`` branch of the JAX factory: num_pos_feats = hidden_dim."""
    if kind == "sine":
        return PositionEmbeddingSine(num_pos_feats=hidden_dim)
    raise NotImplementedError(f"position embedding {kind!r} is not ported yet")
