"""SVANet, the DETR-style set-prediction head (port of
svol_tpu/models/svanet.py): input projections, sine video positions, learned
queries, the cross-modal transformer, a linear fg/bg class head and a
3-layer box MLP with sigmoid, with per-layer auxiliary outputs.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from svol_tpu_torch.models.cross_modal_transformer import CrossModalTransformer
from svol_tpu_torch.models.layers import BoxHeadMLP, InputProjection, Linear
from svol_tpu_torch.models.positional import make_position_embedding


class SVANet(nn.Module):
    def __init__(self, input_vid_dim: int = 512, input_skch_dim: int = 512,
                 hidden_dim: int = 256, nheads: int = 8, num_layers: int = 2,
                 num_queries: int = 320, dim_feedforward: int = 2048,
                 aux_loss: bool = True, n_input_proj: int = 2,
                 num_classes: int = 2, video_position_embedding: str = "sine",
                 use_pallas: bool = False, use_flash: bool = False,
                 input_dropout: float = 0.0, flash_int8: bool = False):
        super().__init__()
        self.aux_loss = aux_loss
        self.num_layers = num_layers
        self.input_video_proj = InputProjection(input_vid_dim, hidden_dim,
                                                n_input_proj, input_dropout)
        self.input_sketch_proj = InputProjection(input_skch_dim, hidden_dim,
                                                 n_input_proj, input_dropout)
        self.video_position_embed = make_position_embedding(
            video_position_embedding, hidden_dim)
        self.query_embed = nn.Parameter(torch.empty(num_queries, hidden_dim))
        self.transformer = CrossModalTransformer(
            hidden_dim, nheads, num_layers, dim_feedforward, use_pallas, use_flash,
            flash_int8)
        self.class_embed = Linear(hidden_dim, num_classes)
        self.bbox_embed = BoxHeadMLP(hidden_dim, 4, 3)

    def forward(self, src_sketch: torch.Tensor, src_video: torch.Tensor,
                src_video_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                ) -> Dict[str, torch.Tensor]:
        # src_video_mask: (B, L), 1 = valid. The sketch is a single token
        # with no sequence structure: it takes no mask and no positions.
        # generator: the dropout masks' source in train mode.
        vid = self.input_video_proj(src_video, generator)
        skch = self.input_sketch_proj(src_sketch, generator)
        vid_valid = src_video_mask.bool()
        vid_pos = self.video_position_embed(vid_valid).to(vid.dtype)
        hs = self.transformer(vid, skch, ~vid_valid, vid_pos, self.query_embed)
        logits = self.class_embed(hs)
        boxes = torch.sigmoid(self.bbox_embed(hs))
        out = {"pred_logits": logits[-1], "pred_boxes": boxes[-1]}
        if self.aux_loss and self.num_layers > 1:
            out["aux_logits"] = logits[:-1]
            out["aux_boxes"] = boxes[:-1]
        return out
