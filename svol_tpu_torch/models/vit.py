"""ViT-B/16 encoder with the HuggingFace ViTModel topology (port of
svol_tpu/models/vit.py).

Pre-LN encoder layers (LayerNorm eps 1e-12, exact-erf GELU), a 16 x 16
stride-16 patch embedding, a zero-initialized CLS token and learned
positions; the forward returns ``(last_hidden_state, pre_ln_hidden_state)``.
Submodules are named after the flax tree (``layer{i}.ln_before``, ``.q``,
``.k``, ``.v``, ``.attn_out``, ``.ln_after``, ``.mlp_in``, ``.mlp_out``,
``ln_final``), so utils/jax_weights.py maps the weights mechanically.

With ``use_flash`` the self-attention runs ``flash_self_attention_bld``
(the (B, L, D) kernel, which reads each head's columns of the q/k/v
projections in place) and every LayerNorm runs ``fused_layer_norm``, the
kernel the JAX package's ``_layer_norm(..., fused)`` names (its ViT runs
flax's ``nn.LayerNorm``, the same function); otherwise the attention takes
the JAX module's head-major einsum path and the LayerNorms their plain
version. Parameters stay float32 and are cast to the activation's dtype at
each use, as flax's ``dtype=`` modules do. Serving only: the kernels are
forward only on the card, and ``remat`` is not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from svol_tpu_torch.models.layers import Linear
from svol_tpu_torch.ops.kernels.flash_attention import flash_self_attention_bld
from svol_tpu_torch.ops.kernels.layer_norm import FusedLayerNorm

LN_EPS_VIT = 1e-12  # HF ViT layer_norm_eps


class ViTEncoderLayer(nn.Module):
    def __init__(self, hidden_size: int = 768, num_heads: int = 12,
                 mlp_dim: int = 3072, use_flash: bool = False):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} not divisible by "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.ln_before = FusedLayerNorm(hidden_size, LN_EPS_VIT, use_flash)
        self.q = Linear(hidden_size, hidden_size)
        self.k = Linear(hidden_size, hidden_size)
        self.v = Linear(hidden_size, hidden_size)
        self.attn_out = Linear(hidden_size, hidden_size)
        self.ln_after = FusedLayerNorm(hidden_size, LN_EPS_VIT, use_flash)
        self.mlp_in = Linear(hidden_size, mlp_dim)
        self.mlp_out = Linear(mlp_dim, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ln_before(x)
        B, L, D = h.shape
        H = self.num_heads
        hd = D // H
        q, k, v = self.q(h), self.k(h), self.v(h)
        if self.use_flash:
            attn = flash_self_attention_bld(q, k, v, hd ** -0.5, H)
        else:
            heads = lambda t: t.reshape(B, L, H, hd).transpose(1, 2)
            q, k, v = heads(q), heads(k), heads(v)
            # JAX multiplies by a Python scalar in the array's dtype
            scale = float(torch.tensor(hd ** -0.5, dtype=q.dtype))
            logits = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
            w = torch.softmax(logits, dim=-1).to(v.dtype)
            attn = torch.matmul(w, v).transpose(1, 2).reshape(B, L, D)
        x = x + self.attn_out(attn)
        h = self.mlp_in(self.ln_after(x))
        h = self.mlp_out(F.gelu(h))
        return x + h


class PatchEmbed(nn.Conv2d):
    """The 16 x 16 stride-16 patch conv with bias, run in the input's dtype:
    (N, H, W, 3) NHWC in, (N, h * w, D) tokens out in (h, w) order."""

    def __init__(self, hidden_size: int, patch_size: int):
        super().__init__(3, hidden_size, patch_size, stride=patch_size)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        # the NHWC tensor viewed as NCHW with channels-last strides
        y = F.conv2d(images.permute(0, 3, 1, 2), self.weight.to(images.dtype),
                     self.bias.to(images.dtype), stride=self.stride)
        return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, y.shape[1])


class ViT(nn.Module):
    """ViT encoder returning (last_hidden_state, pre_ln_hidden_state).

    ``final_ln_cls_only`` applies the final LayerNorm to the CLS row only
    (LayerNorm is per token), so the first output then has length 1."""

    def __init__(self, hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072,
                 patch_size: int = 16, image_size: int = 224,
                 use_flash: bool = False, final_ln_cls_only: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.final_ln_cls_only = final_ln_cls_only
        n_patches = (image_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(hidden_size, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_size))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 1, hidden_size))
        for i in range(num_layers):
            self.add_module(f"layer{i}", ViTEncoderLayer(
                hidden_size, num_heads, mlp_dim, use_flash))
        self.ln_final = FusedLayerNorm(hidden_size, LN_EPS_VIT, use_flash)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        # images: (N, H, W, 3) in the compute dtype
        x = self.patch_embed(images)
        N, _, D = x.shape
        cls = self.cls_token.to(x.dtype).expand(N, 1, D)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
        pre_ln = x
        if self.final_ln_cls_only:
            x = x[:, :1]
        return self.ln_final(x), pre_ln


def vit_base_patch16(image_size: int = 224, use_flash: bool = False,
                     final_ln_cls_only: bool = False) -> ViT:
    return ViT(image_size=image_size, use_flash=use_flash,
               final_ln_cls_only=final_ln_cls_only)
