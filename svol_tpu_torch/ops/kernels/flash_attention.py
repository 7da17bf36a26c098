"""Unmasked attention, softmax(q k^T scale) v, over (BH, L, d) tensors.

Port of svol_tpu/ops/pallas/flash_attention.py: the forward of `_kernel`
(video self-attention, L = T*49) and `_kernel_packed` (query
self-attention, L = Q). Both are one hand-written CUDA kernel,
``csrc/flash_attention.cu``, launched in two shapes: one thread per query
row for long sequences, four threads per row for short ones, where one
thread per row leaves the card under-filled. The choice follows the same
size rule the JAX package uses to pack batch-heads (``_PACK_LOGITS_BYTES``).

Inference only: the training slice ports the backward (`_bwd_kernel`).
"""
from __future__ import annotations

import ctypes

import torch

from svol_tpu_torch.ops.kernels import build

# a short sequence's f32 logits tile fits this many bytes (the JAX package's
# _PACK_LOGITS_BYTES): launch four threads per query row
_SPLIT_LOGITS_BYTES = 1024 * 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32,)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """Plain PyTorch version, mirroring the JAX ``attention_reference``:
    q scaled in its own dtype, f32 logits and softmax, weights cast to q's
    dtype before the f32-accumulated product with v."""
    qs = q * _in_dtype(scale, q.dtype)
    logits = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w.to(q.dtype).float(), v.float()).to(q.dtype)


def _in_dtype(x: float, dtype: torch.dtype) -> float:
    # JAX multiplies by a Python scalar in the array's dtype
    return float(torch.tensor(x, dtype=dtype))


def threads_per_row(lq: int, lk: int) -> int:
    """Launch shape: 4 threads share a query row when the sequence is short."""
    return 4 if lq * lk * 4 <= _SPLIT_LOGITS_BYTES else 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """(BH, Lq, d) attention output in q's dtype. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is inference-only: its backward is not ported")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v must share float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    bh, lq, d = q.shape
    lk = k.shape[1]
    if d not in _HEAD_DIMS or lq == 0 or lk == 0:
        raise ValueError(f"flash_attention: head dim {d} not in {_HEAD_DIMS} "
                         f"or empty sequence (lq={lq}, lk={lk})")
    if not all(t.is_contiguous() and t.device == q.device for t in (k, v)) \
            or not q.is_contiguous():
        raise ValueError("flash_attention: q/k/v must be contiguous on one device")
    lib = _lib()
    o = torch.empty_like(q)
    tpr = threads_per_row(lq, lk)
    rc = lib.svol_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, lq, lk, d,
        _in_dtype(scale, q.dtype), _DTYPES[q.dtype], tpr,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.svol_error_string(rc).decode())
    flash_attention.launches += 1
    if tpr > 1:
        flash_attention.launches_short += 1
    return o


# launches of the kernel; launches_short counts those with 4 threads per row
flash_attention.launches = 0
flash_attention.launches_short = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if not getattr(lib, "_svol_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.svol_flash_attention.argtypes = [p, p, p, p, i, i, i, i,
                                             ctypes.c_float, i, i, p]
        lib.svol_flash_attention.restype = i
        lib.svol_error_string.argtypes = [i]
        lib.svol_error_string.restype = ctypes.c_char_p
        lib._svol_typed = True
    return lib
