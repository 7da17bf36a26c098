"""Attention, projection and MLP blocks (port of svol_tpu/models/layers.py).

Submodule and parameter names follow the flax tree (``q_proj``, ``fc1``,
``norm`` ...) so that utils/jax_weights.py maps it mechanically. Parameters
stay float32 and are cast to the activation's dtype at each use, as flax's
``dtype=`` modules do; the gated op keeps its weights float32, as its JAX
module does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from svol_tpu_torch.ops.kernels.flash_attention import flash_attention
from svol_tpu_torch.ops.kernels.flash_attention_int8 import flash_attention_int8
from svol_tpu_torch.ops.kernels.gated_attention import (
    gated_attention,
    gated_attention_reference,
)
from svol_tpu_torch.ops.quant import record_amax

# torch.nn.LayerNorm default eps (flax default is 1e-6)
LN_EPS = 1e-5


class Linear(nn.Linear):
    """``nn.Linear`` run in the input's dtype (flax ``Dense(dtype=...)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with eps 1e-5, run in the input's dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention math, batch-first, output only.

    Dispatch as in the JAX module: the unmasked path with ``use_flash`` runs
    the flash kernel; otherwise logits are materialized — in bf16 with an f32
    max and sum under a bf16 compute dtype, else in f32. Masked logits are
    filled with the dtype's finite minimum, so an all-padded row gives
    uniform weights, not NaN.

    ``flash_int8`` (serving, eval mode only) sends the flash path through
    the int8 attention: with static scales when the ``amax_q/k/v`` buffers
    hold calibrated abs-maxes, dynamic ones while they are None. With
    ``calibrating`` set it records the projected q, k and v's running
    abs-maxes and runs the exact flash kernel.
    """

    def __init__(self, d_model: int, num_heads: int, use_flash: bool = False,
                 flash_int8: bool = False):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by {num_heads} heads")
        self.d_model, self.num_heads = d_model, num_heads
        self.use_flash = use_flash
        self.flash_int8 = flash_int8
        if flash_int8:
            for name in ("amax_q", "amax_k", "amax_v"):
                self.register_buffer(name, None)
            self.calibrating = False
        self.q_proj = Linear(d_model, d_model)
        self.k_proj = Linear(d_model, d_model)
        self.v_proj = Linear(d_model, d_model)
        self.out_proj = Linear(d_model, d_model)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        # key_padding_mask: (B, Lk), True = padded
        H, hd = self.num_heads, self.d_model // self.num_heads
        B, Lq, _ = query.shape
        Lk = key.shape[1]
        heads = lambda x, L: x.reshape(B, L, H, hd).transpose(1, 2)  # (B, H, L, hd)
        q = heads(self.q_proj(query), Lq)
        k = heads(self.k_proj(key), Lk)
        v = heads(self.v_proj(value), Lk)
        # JAX multiplies by a Python scalar in the array's dtype
        scale = float(torch.tensor(hd ** -0.5, dtype=q.dtype))

        if self.use_flash and key_padding_mask is None:
            qf, kf, vf = (t.reshape(B * H, -1, hd) for t in (q, k, v))
            int8 = self.flash_int8 and not self.training
            if int8 and self.calibrating:
                for name, t in (("amax_q", q), ("amax_k", k), ("amax_v", v)):
                    record_amax(self, name, t)
            if int8 and not self.calibrating:
                static = None if self.amax_q is None else (
                    self.amax_q, self.amax_k, self.amax_v)
                out = flash_attention_int8(qf, kf, vf, hd ** -0.5, static)
            else:
                # the kernel scales q in its dtype itself; its backward
                # applies the unrounded scale in f32, as the JAX kernel does
                out = flash_attention(qf, kf, vf, hd ** -0.5)
            out = out.reshape(B, H, Lq, hd)
        elif q.dtype == torch.bfloat16:
            # bf16 logits; max-subtraction and normalizing sum in f32
            logits = torch.matmul(q * scale, k.transpose(-1, -2))
            if key_padding_mask is not None:
                logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                            torch.finfo(torch.bfloat16).min)
            m = logits.amax(dim=-1, keepdim=True).float().detach()
            e = torch.exp((logits.float() - m).to(torch.bfloat16))
            denom = e.sum(dim=-1, keepdim=True, dtype=torch.float32)
            out = torch.matmul(e / denom.to(torch.bfloat16), v)
        else:
            logits = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
            if key_padding_mask is not None:
                logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                            torch.finfo(torch.float32).min)
            out = torch.matmul(torch.softmax(logits, dim=-1).to(q.dtype), v)
        return self.out_proj(out.transpose(1, 2).reshape(B, Lq, self.d_model))


class GatedSketchVideoAttention(nn.Module):
    """Block 1 of the cross-modal layer: the sketch token's head-averaged
    attention weights over the video gate the video stream. Weights are raw
    (in, out) float32 parameters named as in the flax tree. Returns
    (att1 (B, 1, L), gated (B, L, D))."""

    def __init__(self, d_model: int, num_heads: int, use_kernel: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.use_kernel = use_kernel
        self.q_proj_kernel = nn.Parameter(torch.empty(d_model, d_model))
        self.q_proj_bias = nn.Parameter(torch.zeros(d_model))
        self.k_proj_kernel = nn.Parameter(torch.empty(d_model, d_model))
        self.k_proj_bias = nn.Parameter(torch.zeros(d_model))

    def forward(self, sketch: torch.Tensor, k_input: torch.Tensor,
                mem: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        fn = gated_attention if self.use_kernel else gated_attention_reference
        g, gated = fn(sketch, k_input, mem, self.q_proj_kernel,
                      self.q_proj_bias, self.k_proj_kernel, self.k_proj_bias,
                      self.num_heads)
        return g[:, None, :], gated


class TransformerMLP(nn.Module):
    """fc1 -> GELU (tanh approximation, as flax ``nn.gelu``) -> fc2."""

    def __init__(self, d_model: int, hidden_features: int, out_features: int):
        super().__init__()
        self.fc1 = Linear(d_model, hidden_features)
        self.fc2 = Linear(hidden_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class BoxHeadMLP(nn.Module):
    """DETR-style head MLP with ReLU between layers."""

    def __init__(self, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            out = output_dim if i == num_layers - 1 else hidden_dim
            self.add_module(f"layer{i}", Linear(hidden_dim, out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and
    scale kept ones by 1 / (1 - rate), in x's dtype. The mask comes from
    ``generator`` (on x's device), never from the global RNG."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))


class LinearLayer(nn.Module):
    """LayerNorm -> dropout (train mode only) -> Linear [-> ReLU]."""

    def __init__(self, in_dim: int, out_dim: int, relu: bool = True,
                 dropout: float = 0.0):
        super().__init__()
        self.norm = LayerNorm(in_dim)
        self.linear = Linear(in_dim, out_dim)
        self.relu = relu
        self.dropout = dropout

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.norm(x)
        if self.training:
            x = dropout(x, self.dropout, generator)
        x = self.linear(x)
        return F.relu(x) if self.relu else x


class InputProjection(nn.Module):
    """n LinearLayers to hidden_dim, ReLU on all but the last."""

    def __init__(self, in_dim: int, hidden_dim: int, n_layers: int = 2,
                 dropout: float = 0.0):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"proj{i}", LinearLayer(
                in_dim if i == 0 else hidden_dim, hidden_dim,
                relu=i < n_layers - 1, dropout=dropout))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"proj{i}")(x, generator)
        return x
