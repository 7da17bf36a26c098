"""ResNet-18/34 trunk, torchvision topology (port of svol_tpu/models/resnet.py).

Inputs and outputs are NHWC like the JAX package; inside, the NHWC tensor
is viewed as NCHW with channels-last strides, the layout cuDNN runs natively.
BatchNorm follows ``module.train()`` / ``.eval()`` as the JAX ``train=`` flag
does: batch statistics with flax's running-average update in train mode,
running statistics in eval mode.

Parameters stay float32 (as flax keeps them) and are cast to the
activation's dtype at each use, so a bfloat16 forward rounds exactly where
the JAX model's ``dtype=bfloat16`` modules do. With ``quantize='int8'``
every conv runs the int8 path of ops/quant.py in eval mode; train mode
keeps the float convs, as the JAX package's ``quantize=None if train``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from svol_tpu_torch.ops.quant import int8_conv, record_amax

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax convention: ra = 0.9 * ra + 0.1 * batch statistic


class QuantizableConv(nn.Module):
    """Bias-free conv. ``weight`` is OIHW; ``kernel_scale`` folds a constant
    input scale into the kernel: conv(s*x, k) == conv(x, s*k), which is how
    uint8 pixels skip a separate /255 pass.

    ``quantize='int8'`` in eval mode runs ``int8_conv`` on the scaled
    kernel: with static scales when the ``amax`` buffer holds a calibrated
    abs-max, dynamic ones while it is None. With ``calibrating`` set, the
    conv records its input's running abs-max into ``amax`` and returns the
    exact float output."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 quantize: Optional[str] = None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(features, in_ch, kernel_size, kernel_size))
        self.stride = stride
        self.padding = padding
        self.quantize = quantize
        if quantize == "int8":
            self.register_buffer("amax", None)
            self.calibrating = False
        elif quantize is not None:
            raise NotImplementedError(f"quantize={quantize!r}")

    def forward(self, x: torch.Tensor, kernel_scale: float = 1.0) -> torch.Tensor:
        w = self.weight
        if kernel_scale != 1.0:
            w = w * kernel_scale
        if self.quantize and not self.training:
            if self.calibrating:
                record_amax(self, "amax", x)
            else:
                return int8_conv(x, w, self.stride, self.padding,
                                 static_amax=self.amax)
        return F.conv2d(x, w.to(x.dtype), stride=self.stride,
                        padding=self.padding)


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` semantics; statistics stay float32.

    Eval mode normalizes with the running statistics. Train mode normalizes
    with the batch mean and the biased variance (eps 1e-5) over every
    position of the batch, padded frames included, and updates
    ``ra = 0.9 * ra + 0.1 * batch_stat`` with the biased variance for the
    running variance too, where ``nn.BatchNorm2d`` would use the unbiased
    one. One ``F.batch_norm`` pass yields the batch statistics into scratch
    buffers (momentum 1); its unbiased variance is rescaled by (n - 1) / n.
    """

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False, eps=BN_EPS)
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, training=True,
                         momentum=1.0, eps=BN_EPS)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(
                var, alpha=(1 - BN_MOMENTUM) * (n - 1) / n)
        return y


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 quantize: Optional[str] = None):
        super().__init__()
        self.conv1 = QuantizableConv(in_ch, filters, 3, stride, 1, quantize)
        self.bn1 = BatchNorm(filters)
        self.conv2 = QuantizableConv(filters, filters, 3, 1, 1, quantize)
        self.bn2 = BatchNorm(filters)
        self.has_downsample = stride != 1 or in_ch != filters
        if self.has_downsample:
            self.downsample_conv = QuantizableConv(in_ch, filters, 1, stride,
                                                   quantize=quantize)
            self.downsample_bn = BatchNorm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """``include_pool=True`` ends in global average pooling, (N, C) — the
    sketch path; otherwise the final map is returned NHWC — the video path."""

    def __init__(self, stage_sizes: Sequence[int], include_pool: bool = False,
                 quantize: Optional[str] = None):
        super().__init__()
        self.include_pool = include_pool
        self.conv1 = QuantizableConv(3, 64, 7, stride=2, padding=3,
                                     quantize=quantize)
        self.bn1 = BatchNorm(64)
        in_ch = 64
        self.block_names = []
        for stage, n_blocks in enumerate(stage_sizes):
            filters = 64 * 2 ** stage
            for b in range(n_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, BasicBlock(in_ch, filters, stride, quantize))
                self.block_names.append(name)
                in_ch = filters

    def forward(self, x: torch.Tensor, input_scale: float = 1.0) -> torch.Tensor:
        # x: (N, H, W, 3), already in the compute dtype
        y = self.conv1(x.permute(0, 3, 1, 2), kernel_scale=input_scale)
        y = F.relu(self.bn1(y))
        y = F.max_pool2d(y, kernel_size=3, stride=2, padding=1)
        for name in self.block_names:
            y = getattr(self, name)(y)
        if self.include_pool:
            return y.mean(dim=(2, 3))  # (N, C)
        return y.permute(0, 2, 3, 1)  # (N, h, w, C)


def resnet18(include_pool: bool = False, quantize: Optional[str] = None) -> ResNet:
    return ResNet((2, 2, 2, 2), include_pool, quantize)


def resnet34(include_pool: bool = False, quantize: Optional[str] = None) -> ResNet:
    return ResNet((3, 4, 6, 3), include_pool, quantize)
