"""Cross-modal transformer, dense branch (port of
svol_tpu/models/cross_modal_transformer.py).

Per layer:
  1. the sketch token's head-averaged attention weights over the video gate
     the video stream: mem = LN(mem + g * mem);
  2. video self-attention (no key-padding mask, as in the reference) +
     residual + LN, then MLP + residual + LN;
  3. query-token self-attention (no mask) + residual + LN;
  4. token->content cross-attention with the video key-padding mask,
     residual + LN, then MLP + residual + LN.
The decoder state starts at zeros and the learned query embedding is the
query position, broadcast over the batch.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from svol_tpu_torch.models.layers import (
    GatedSketchVideoAttention,
    LayerNorm,
    MultiheadAttention,
    TransformerMLP,
)


class CrossModalTransformerLayer(nn.Module):
    def __init__(self, d_model: int = 256, nhead: int = 8,
                 dim_feedforward: int = 2048, use_pallas: bool = False,
                 use_flash: bool = False, flash_int8: bool = False):
        super().__init__()
        self.sketch_video_cross_attn = GatedSketchVideoAttention(
            d_model, nhead, use_kernel=use_pallas)
        self.content_self_attn = MultiheadAttention(d_model, nhead, use_flash,
                                                    flash_int8)
        self.token_self_attn = MultiheadAttention(d_model, nhead, use_flash,
                                                  flash_int8)
        self.content_token_cross_attn = MultiheadAttention(d_model, nhead)
        self.mlp1 = TransformerMLP(d_model, dim_feedforward, d_model)
        self.mlp2 = TransformerMLP(d_model, dim_feedforward, d_model)
        for i in range(1, 7):
            self.add_module(f"norm{i}", LayerNorm(d_model))

    def forward(self, mem, src_skch, out, vid_pad_mask, vid_pos, query_pos,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        _, gated = self.sketch_video_cross_attn(src_skch, mem + vid_pos, mem)
        mem = self.norm1(mem + gated)

        qk = mem + vid_pos
        mem = self.norm2(self.content_self_attn(qk, qk, mem) + mem)
        mem = self.norm3(mem + self.mlp1(mem))

        qk = out + query_pos
        out = self.norm4(self.token_self_attn(qk, qk, out) + out)

        attn_out = self.content_token_cross_attn(
            out + query_pos, mem + vid_pos, mem, key_padding_mask=vid_pad_mask)
        out = self.norm5(out + attn_out)
        out = self.norm6(out + self.mlp2(out))
        return mem, out


class CrossModalTransformer(nn.Module):
    """Returns the per-layer query states, (num_layers, B, Q, D)."""

    def __init__(self, d_model: int = 256, nhead: int = 8, num_layers: int = 2,
                 dim_feedforward: int = 2048, use_pallas: bool = False,
                 use_flash: bool = False, flash_int8: bool = False):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", CrossModalTransformerLayer(
                d_model, nhead, dim_feedforward, use_pallas, use_flash, flash_int8))

    def forward(self, src_vid, src_skch, vid_pad_mask, vid_pos, query_embed,
                ) -> torch.Tensor:
        B = src_vid.shape[0]
        query_pos = query_embed[None].expand((B,) + query_embed.shape).to(src_vid.dtype)
        out = torch.zeros_like(query_pos)
        mem = src_vid
        outputs = []
        for i in range(self.num_layers):
            mem, out = getattr(self, f"layer{i}")(
                mem, src_skch, out, vid_pad_mask, vid_pos, query_pos)
            outputs.append(out)
        return torch.stack(outputs)
