"""Top-level model: ResNet or ViT backbone + SVANet head (port of the svanet
branch of svol_tpu/models/model.py).

uint8 pixels are cast to the compute dtype on the device. For the ResNet
the /255 normalization folds into the stem conv's kernel (conv is
linear); for the ViT they are divided by 255 in the compute dtype, as the
JAX model does (in bfloat16 the rounding points matter). Float pixels in
[0, 1] pass unscaled (the ViT normalizes them in their own dtype, then
casts). ``model.train()`` / ``.eval()`` play the
JAX ``train=`` flag: BatchNorm batch statistics and input dropout in train
mode, running statistics and no dropout in eval mode. With
``quantize='int8'`` the eval-mode forward serves int8 (ops/quant.py, and
the int8 attention with ``quantize_attention``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from svol_tpu_torch.config import SvolConfig
from svol_tpu_torch.models.backbone import (
    ResNetBackbone,
    ViTBackbone,
    backbone_feature_dims,
    tokens_per_frame,
)
from svol_tpu_torch.models.svanet import SVANet

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class SketchLocalizationModel(nn.Module):
    def __init__(self, config: SvolConfig):
        super().__init__()
        cfg = config.model
        self.dtype = DTYPES[cfg.compute_dtype]
        self.fold = cfg.backbone == "resnet"
        self.backbone = (ResNetBackbone(cfg.quantize) if self.fold else
                         ViTBackbone(config.data.image_size, cfg.use_flash_attention,
                                     self.dtype))
        vid_dim, skch_dim = backbone_feature_dims(cfg.backbone)
        self.tokens_per_frame = tokens_per_frame(cfg.backbone, config.data.image_size)
        self.head = SVANet(
            input_vid_dim=vid_dim, input_skch_dim=skch_dim,
            hidden_dim=cfg.hidden_dim, nheads=cfg.nheads,
            num_layers=cfg.num_layers, num_queries=cfg.num_queries,
            dim_feedforward=cfg.cmt_dim_feedforward, aux_loss=cfg.aux_loss,
            n_input_proj=cfg.n_input_proj, num_classes=cfg.num_classes,
            video_position_embedding=cfg.video_position_embedding,
            use_pallas=cfg.use_pallas_attention,
            use_flash=cfg.use_flash_attention,
            input_dropout=cfg.input_dropout,
            flash_int8=cfg.quantize == "int8" and cfg.quantize_attention,
        )

    def forward(self, src_sketch: torch.Tensor, src_video: torch.Tensor,
                src_sketch_mask: torch.Tensor, src_video_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                ) -> Dict[str, torch.Tensor]:
        # src_sketch (B, 1, H, W, 3), src_video (B, T, H, W, 3): uint8 pixels
        # or floats in [0, 1]; masks (B, 1) / (B, T), 1 = valid. The sketch
        # mask is part of the input schema but, as in the JAX model's sine
        # configuration, nothing consumes it. generator: the source of the
        # dropout masks in train mode, on the model's device.
        if self.fold:
            sketch_scale = 1.0 / 255.0 if not src_sketch.is_floating_point() else 1.0
            video_scale = 1.0 / 255.0 if not src_video.is_floating_point() else 1.0
            feat_sketch, feat_video = self.backbone(
                src_sketch.to(self.dtype), src_video.to(self.dtype),
                sketch_scale=sketch_scale, video_scale=video_scale)
        else:
            pixels = lambda x: (x if x.is_floating_point()
                                else x.to(self.dtype) / 255.0)
            feat_sketch, feat_video = self.backbone(pixels(src_sketch),
                                                    pixels(src_video))
        rep = self.tokens_per_frame
        if feat_video.shape[1] != src_video.shape[1] * rep:
            raise ValueError(
                f"{tuple(src_video.shape[2:4])} frames give "
                f"{feat_video.shape[1] // src_video.shape[1]} tokens per frame; "
                f"the config's image_size expects {rep}")
        # repeat each frame's flag over its tokens (an expand, which needs no
        # host synchronization)
        B, T = src_video_mask.shape
        video_mask = src_video_mask[:, :, None].expand(B, T, rep).reshape(B, T * rep)
        return self.head(feat_sketch, feat_video, video_mask, generator)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``: lecun-normal convs, xavier-uniform
    matrices, N(0, 1) query embeddings, N(0, 0.02) ViT positions, a zero
    CLS token, unit norms and zero biases, running statistics (0, 1) — the
    flax initializers' distributions, not their draws."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "pos_embed":
            p.normal_(0.0, 0.02, generator=generator)
        elif leaf == "cls_token":
            p.zero_()
        elif p.dim() == 4:
            fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            p.normal_(0.0, fan_in ** -0.5, generator=generator)
        elif leaf == "query_embed":
            p.normal_(0.0, 1.0, generator=generator)
        elif p.dim() == 2:
            bound = (6.0 / (p.shape[0] + p.shape[1])) ** 0.5
            p.uniform_(-bound, bound, generator=generator)
        elif leaf.endswith("bias"):
            p.zero_()
        else:
            p.fill_(1.0)
    for name, b in model.named_buffers():
        b.fill_(1.0 if name.endswith("running_var") else 0.0)
