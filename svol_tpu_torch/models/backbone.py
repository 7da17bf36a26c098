"""Video + sketch backbones (port of svol_tpu/models/backbone.py).

ResNet path:
  sketch -> ResNet-18 with global pool -> one 512-d token per clip;
  video  -> ResNet-34 without pool -> a 7x7x512 map per frame at 224 px,
  flattened to (B, T*h*w, 512) in (t, h, w) order.
ViT path: ViT-B/16 over the sketch and over every frame, the (x - 0.5) / 0.5
scaling first, then the CLS token of the final LayerNorm'ed hidden state
(one 768-d token per sketch and per frame).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from svol_tpu_torch.models.resnet import resnet18, resnet34
from svol_tpu_torch.models.vit import vit_base_patch16


class ResNetBackbone(nn.Module):
    def __init__(self, quantize: Optional[str] = None):
        super().__init__()
        self.sketch_backbone = resnet18(include_pool=True, quantize=quantize)
        self.video_backbone = resnet34(include_pool=False, quantize=quantize)

    def forward(self, sketch: torch.Tensor, video: torch.Tensor,
                sketch_scale: float = 1.0, video_scale: float = 1.0,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        # sketch (B, 1, H, W, 3), video (B, T, H, W, 3)
        B, T = video.shape[:2]
        src_sketch = self.sketch_backbone(
            sketch[:, 0], input_scale=sketch_scale)[:, None, :]  # (B, 1, C)
        fmap = self.video_backbone(video.reshape((B * T,) + video.shape[2:]),
                                   input_scale=video_scale)  # (B*T, h, w, C)
        h, w, c = fmap.shape[1:]
        # the NHWC permute of an NCHW map: (t, h, w) token order
        return src_sketch, fmap.reshape(B, T * h * w, c)


class ViTBackbone(nn.Module):
    """ViT-B/16 for the sketch and for the frames, named ``sketch_backbone``
    and ``video_backbone``. The four flags keep the JAX defaults: features
    after the final LayerNorm (``norm_*_feats``), the CLS token
    (``use_*_cls_token``) rather than the mean of the patch tokens. When a
    side reads only the normalized CLS row, its final LayerNorm runs over
    that row only. The ViTs run in ``dtype``, to which the scaled images
    are cast, as flax's ``dtype=`` patch conv casts its input."""

    def __init__(self, image_size: int = 224, use_flash: bool = False,
                 dtype: torch.dtype = torch.float32,
                 norm_sketch_feats: bool = True,
                 use_sketch_cls_token: bool = True,
                 norm_vid_feats: bool = True, use_vid_cls_token: bool = True):
        super().__init__()
        self.dtype = dtype
        self.norm_sketch_feats = norm_sketch_feats
        self.use_sketch_cls_token = use_sketch_cls_token
        self.norm_vid_feats = norm_vid_feats
        self.use_vid_cls_token = use_vid_cls_token
        self.sketch_backbone = vit_base_patch16(
            image_size, use_flash,
            final_ln_cls_only=norm_sketch_feats and use_sketch_cls_token)
        self.video_backbone = vit_base_patch16(
            image_size, use_flash,
            final_ln_cls_only=norm_vid_feats and use_vid_cls_token)

    @staticmethod
    def _pick(hidden, pre_ln, norm: bool, use_cls: bool) -> torch.Tensor:
        feats = hidden if norm else pre_ln
        return feats[:, 0, :] if use_cls else feats[:, 1:, :].mean(dim=1)

    def forward(self, sketch: torch.Tensor, video: torch.Tensor,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        # sketch (B, 1, H, W, 3), video (B, T, H, W, 3), floats in [0, 1];
        # the ViTFeatureExtractor normalization in their dtype
        scale = lambda x: ((x - 0.5) / 0.5).to(self.dtype)
        s_hidden, s_pre = self.sketch_backbone(scale(sketch[:, 0]))
        src_sketch = self._pick(s_hidden, s_pre, self.norm_sketch_feats,
                                self.use_sketch_cls_token)[:, None, :]  # (B, 1, D)
        B, T = video.shape[:2]
        v_hidden, v_pre = self.video_backbone(
            scale(video.reshape((B * T,) + video.shape[2:])))
        per_frame = self._pick(v_hidden, v_pre, self.norm_vid_feats,
                               self.use_vid_cls_token)  # (B*T, D)
        return src_sketch, per_frame.reshape(B, T, -1)


def backbone_feature_dims(backbone: str) -> Tuple[int, int]:
    """(input_vid_dim, input_skch_dim) the head expects."""
    if "vit" in backbone:
        return 768, 768
    if "resnet" in backbone:
        return 512, 512
    raise NotImplementedError(backbone)


def tokens_per_frame(backbone: str, image_size: int = 224) -> int:
    """Video tokens per frame: the ResNet map is (image_size / 32)^2, the
    ViT gives one (its CLS token)."""
    if "vit" in backbone:
        return 1
    if "resnet" in backbone:
        return (image_size // 32) ** 2
    raise NotImplementedError(backbone)
