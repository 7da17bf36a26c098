"""Video + sketch ResNet backbones (port of svol_tpu/models/backbone.py).

sketch -> ResNet-18 with global pool -> one 512-d token per clip;
video  -> ResNet-34 without pool -> a 7x7x512 map per frame at 224 px,
flattened to (B, T*h*w, 512) in (t, h, w) order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from svol_tpu_torch.models.resnet import resnet18, resnet34


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


def backbone_feature_dims(backbone: str) -> Tuple[int, int]:
    """(input_vid_dim, input_skch_dim) the head expects."""
    if "resnet" in backbone:
        return 512, 512
    raise NotImplementedError(backbone)


def tokens_per_frame(backbone: str, image_size: int = 224) -> int:
    """Video tokens per frame: the ResNet map is (image_size / 32)^2."""
    if "resnet" in backbone:
        return (image_size // 32) ** 2
    raise NotImplementedError(backbone)
