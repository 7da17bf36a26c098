"""Unmasked int8 attention over (BH, L, d) tensors, for serving.

Port of svol_tpu/ops/pallas/flash_attention.py's int8 variant
(``_quant_sym``, ``_pallas_forward_int8`` and its kernel
``_kernel_int8_runtime_scale``). q, k and v are quantized per tensor to
symmetric int8 outside the kernel, with dynamic scales or calibrated
``static_amax``; the kernel takes the int8 tensors and the f32 logit scale
sq * sk * scale and computes, per query row:

    l = q k^T                       (int32)
    s = f32(l) * logit_scale;  m = max_j s;  e = exp(s - m);  denom = sum e
    wq = round(e * 127)             (int8: e peaks at exactly 1 in each row)
    out = f32(wq v) * (1 / (127 * denom))   (int32 product)

and the wrapper multiplies by v's scale and casts to q's dtype. The kernel
is ``csrc/flash_attention_int8.cu``; ``attention_int8_reference`` is its
plain PyTorch version, which CPU tensors take. Serving only: there is no
backward.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from svol_tpu_torch.ops.kernels import build
from svol_tpu_torch.ops.quant import quant_scale, quantize

_HEAD_DIMS = (32,)


def quant_sym(x: torch.Tensor, static_amax: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 (``_quant_sym``): (int8 x, f32 scale)."""
    amax = x.float().abs().amax() if static_amax is None else static_amax
    s = quant_scale(amax)
    return quantize(x, s), s


def attention_int8_reference(qq: torch.Tensor, kq: torch.Tensor, vq: torch.Tensor,
                             logit_scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, (BH, Lq, d) int8 q and (BH, Lk,
    d) int8 k, v -> (BH, Lq, d) f32. The two integer products run in float64,
    where they are exact (|l| <= 127^2 d, |wq v| <= 127^2 Lk, far below
    2^53), so they equal the int32 accumulators."""
    logits = torch.matmul(qq.double(), kq.double().transpose(-1, -2)).to(torch.int32)
    s = logits.float() * logit_scale
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    wq = torch.round(e * 127.0).to(torch.int8)
    acc = torch.matmul(wq.double(), vq.double()).to(torch.int32)
    return acc.float() * (1.0 / (127.0 * denom))


def _check(qq, kq, vq, logit_scale) -> None:
    if not all(t.dtype == torch.int8 for t in (qq, kq, vq)):
        raise TypeError("attention_int8: q/k/v must be int8")
    if qq.dim() != 3 or kq.shape != vq.shape or kq.shape[0] != qq.shape[0] \
            or kq.shape[2] != qq.shape[2]:
        raise ValueError(f"attention_int8: bad shapes q {tuple(qq.shape)}, "
                         f"k {tuple(kq.shape)}, v {tuple(vq.shape)}")
    lq, d = qq.shape[1:]
    if d not in _HEAD_DIMS or lq == 0 or kq.shape[1] == 0:
        raise ValueError(f"attention_int8: head dim {d} not in {_HEAD_DIMS} "
                         f"or empty sequence")
    if logit_scale.dtype != torch.float32 or logit_scale.numel() != 1:
        raise ValueError("attention_int8: logit_scale must be one float32")
    for t in (qq, kq, vq, logit_scale):
        if not t.is_contiguous() or t.device != qq.device:
            raise ValueError("attention_int8: inputs must be contiguous on one device")
        if t.data_ptr() % 16:
            raise ValueError("attention_int8: inputs must be 16-byte aligned")


def attention_int8(qq: torch.Tensor, kq: torch.Tensor, vq: torch.Tensor,
                   logit_scale: torch.Tensor) -> torch.Tensor:
    """The kernel's function: CPU tensors take ``attention_int8_reference``;
    CUDA tensors launch ``csrc/flash_attention_int8.cu`` or raise."""
    if qq.device.type == "cpu":
        return attention_int8_reference(qq, kq, vq, logit_scale)
    if qq.device.type != "cuda":
        raise ValueError(f"attention_int8: unsupported device {qq.device}")
    _check(qq, kq, vq, logit_scale)
    bh, lq, d = qq.shape
    lib = _lib()
    o = torch.empty((bh, lq, d), dtype=torch.float32, device=qq.device)
    rc = lib.svol_flash_attention_int8(
        qq.data_ptr(), kq.data_ptr(), vq.data_ptr(), logit_scale.data_ptr(),
        o.data_ptr(), bh, lq, kq.shape[1], d,
        torch.cuda.current_stream(qq.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("attention_int8 launch failed: "
                           + lib.svol_error_string(rc).decode())
    attention_int8.launches += 1
    by_length = attention_int8.launches_by_length
    by_length[lq] = by_length.get(lq, 0) + 1
    return o


# launches of the kernel, in all and by query length (the flagship's video
# self-attention runs at L = 1568, its query self-attention at L = 320)
attention_int8.launches = 0
attention_int8.launches_by_length = {}


def flash_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float,
                         static_amax: Optional[Sequence[torch.Tensor]] = None,
                         ) -> torch.Tensor:
    """(BH, Lq, d) int8 attention output in q's dtype (``flash_self_attention
    _int8`` on (BH, L, d)). ``static_amax``: calibrated (amax_q, amax_k,
    amax_v) f32 scalars, else each tensor's own abs-max."""
    aq, ak, av = static_amax if static_amax is not None else (None,) * 3
    qq, sq = quant_sym(q, aq)
    kq, sk = quant_sym(k, ak)
    vq, sv = quant_sym(v, av)
    # the scale rounded to f32 first, as jnp.float32(scale); a product of
    # two f32 values rounds the same in f32 and in double
    scale32 = float(torch.tensor(scale, dtype=torch.float32))
    logit_scale = (sq * sk * scale32).reshape(1)
    return (attention_int8(qq, kq, vq, logit_scale) * sv).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_int8")
    if not getattr(lib, "_svol_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.svol_flash_attention_int8.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.svol_flash_attention_int8.restype = i
        lib.svol_error_string.argtypes = [i]
        lib.svol_error_string.restype = ctypes.c_char_p
        lib._svol_typed = True
    return lib
