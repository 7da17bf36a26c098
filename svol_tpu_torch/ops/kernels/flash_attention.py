"""Unmasked attention, softmax(q k^T scale) v, over (BH, L, d) tensors, with
its gradient, and over (B, L, H*d) tensors, forward only.

Port of svol_tpu/ops/pallas/flash_attention.py: the forward of `_kernel`
(video self-attention, L = T*49) and `_kernel_packed` (query
self-attention, L = Q), the backward `_bwd_kernel`, and the (B, L, D)
forward `_kernel_bld` (the ViT encoder's self-attention). The forwards are
one hand-written CUDA source, ``csrc/flash_attention.cu``. Its CUDA-core
kernel launches in two shapes: one thread per query row for long
sequences, four threads per row for short ones, where one thread per row
leaves the card under-filled. The choice follows the same size rule the
JAX package uses to pack batch-heads (``_PACK_LOGITS_BYTES``). The
(B, L, D) entry, at ViT-B/16's head dim 64, takes that kernel with four
threads per row in float32 and a tensor-core kernel of the same source
(16 query rows a warp, ``mma.sync``) in bfloat16; it reads each head's
column slice of the projections in place and writes (B, L, D): no
transposed copy. Under autograd the (BH, L, d) forward also saves each
row's logsumexp, and the backward runs ``csrc/flash_attention_bwd.cu`` (a
dQ and a dK/dV kernel, no (L, L) tile anywhere).
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
# the (B, L, D) entry's head dim: ViT-B/16's 768 / 12
_BLD_HEAD_DIM = 64


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """Plain PyTorch version, mirroring the JAX ``attention_reference``:
    q scaled in its own dtype, f32 logits and softmax, weights cast to q's
    dtype before the f32-accumulated product with v."""
    qs = q * _in_dtype(scale, q.dtype)
    logits = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w.to(q.dtype).float(), v.float()).to(q.dtype)


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, g: torch.Tensor,
                                 scale: float):
    """Plain PyTorch version of ``_bwd_kernel``'s math, at its rounding
    points: the f32 softmax rebuilt from q scaled in q's dtype and k;
    dv = w^T g with w cast to v's dtype; dl = w * (dw - rowsum(w * dw)) cast
    to q's dtype; dq = dl k and dk = dl^T q scaled in f32. All products
    accumulate in f32. Returns (dq, dk, dv)."""
    qs = q * _in_dtype(scale, q.dtype)
    w = torch.softmax(torch.matmul(qs.float(), k.float().transpose(-1, -2)), dim=-1)
    dv = torch.matmul(w.to(v.dtype).float().transpose(-1, -2), g.float()).to(v.dtype)
    dw = torch.matmul(g.float(), v.float().transpose(-1, -2))
    delta = (w * dw).sum(dim=-1, keepdim=True)
    dl = (w * (dw - delta)).to(q.dtype).float()
    s = _in_dtype(scale, torch.float32)
    dq = (torch.matmul(dl, k.float()) * s).to(q.dtype)
    dk = (torch.matmul(dl.transpose(-1, -2), q.float()) * s).to(k.dtype)
    return dq, dk, dv


def _in_dtype(x: float, dtype: torch.dtype) -> float:
    # JAX multiplies by a Python scalar in the array's dtype
    return float(torch.tensor(x, dtype=dtype))


def attention_bld_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float,
                            num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of ``_kernel_bld``: ``attention_reference`` on
    each head's column slice of the (B, L, D) operands, the outputs side by
    side in (B, Lq, D)."""
    d = q.shape[-1] // num_heads
    return torch.cat([attention_reference(q[..., h * d:(h + 1) * d],
                                          k[..., h * d:(h + 1) * d],
                                          v[..., h * d:(h + 1) * d], scale)
                      for h in range(num_heads)], dim=-1)


def threads_per_row(lq: int, lk: int) -> int:
    """Launch shape: 4 threads share a query row when the sequence is short."""
    return 4 if lq * lk * 4 <= _SPLIT_LOGITS_BYTES else 1


def _check(name: str, q, k, v) -> None:
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    lq, d = q.shape[1:]
    lk = k.shape[1]
    if d not in _HEAD_DIMS or lq == 0 or lk == 0:
        raise ValueError(f"{name}: head dim {d} not in {_HEAD_DIMS} "
                         f"or empty sequence (lq={lq}, lk={lk})")
    if not all(t.is_contiguous() and t.device == q.device for t in (q, k, v)):
        raise ValueError(f"{name}: q/k/v must be contiguous on one device")


def _forward_kernel(q, k, v, scale: float, with_lse: bool):
    _check("flash_attention", q, k, v)
    bh, lq, d = q.shape
    lk = k.shape[1]
    lib = _lib()
    o = torch.empty_like(q)
    lse = (torch.empty((bh, lq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    tpr = threads_per_row(lq, lk)
    rc = lib.svol_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), bh, lq, lk, d,
        _in_dtype(scale, q.dtype), _DTYPES[q.dtype], tpr,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.svol_error_string(rc).decode())
    flash_attention.launches += 1
    if tpr > 1:
        flash_attention.launches_short += 1
    by_length = flash_attention.launches_by_length
    by_length[lk] = by_length.get(lk, 0) + 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """(BH, Lq, d) attention output in q's dtype. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise. Differentiable: under
    autograd the backward is ``flash_attention_backward``."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _FlashAttention.apply(q, k, v, scale)


# launches of the forward kernel; launches_short counts those with 4
# threads per row, launches_by_length each key length's
flash_attention.launches = 0
flash_attention.launches_short = 0
flash_attention.launches_by_length = {}


def flash_attention_backward(q, k, v, lse, g, scale: float):
    """(dq, dk, dv) of ``flash_attention`` at (q, k, v) for output gradient
    g, given the forward's row logsumexp (CUDA only; None on the CPU). CPU
    tensors take ``attention_backward_reference``; CUDA tensors launch the
    dQ and dK/dV kernels or raise. One call counts one launch."""
    if q.device.type == "cpu":
        return attention_backward_reference(q, k, v, g, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward: unsupported device {q.device}")
    _check("flash_attention_backward", q, k, v)
    bh, lq, d = q.shape
    lk = k.shape[1]
    if g.shape != q.shape or g.dtype != q.dtype or lse is None \
            or lse.shape != (bh, lq) or lse.dtype != torch.float32:
        raise ValueError("flash_attention_backward: g must match q, lse "
                         "must be (BH, Lq) float32")
    if not all(t.is_contiguous() and t.device == q.device for t in (g, lse)):
        raise ValueError("flash_attention_backward: g/lse must be "
                         "contiguous on q's device")
    lib = _bwd_lib()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((bh, lq), dtype=torch.float32, device=q.device)
    rc = lib.svol_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), bh, lq, lk, d, _in_dtype(scale, q.dtype),
        _in_dtype(scale, torch.float32), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash_attention_backward launch failed: "
                           + lib.svol_error_string(rc).decode())
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0


def flash_attention_bld(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, num_heads: int) -> torch.Tensor:
    """Unmasked multi-head attention in (B, L, D) layout: q (B, Lq, D), k and
    v (B, Lk, D), head h the columns [h d, (h + 1) d); returns (B, Lq, D) in
    q's dtype. CPU tensors take ``attention_bld_reference``; CUDA tensors
    launch the kernel or raise. Forward only on the card."""
    if q.device.type == "cpu":
        return attention_bld_reference(q, k, v, scale, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bld: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention_bld: the kernel is forward only; its backward "
            "comes with the ViT training slice of the port")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2] \
            or q.shape[2] % num_heads:
        raise ValueError(f"flash_attention_bld: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} for "
                         f"{num_heads} heads")
    B, lq, D = q.shape
    lk, d = k.shape[1], D // num_heads
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_bld: q/k/v must share float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d != _BLD_HEAD_DIM or lq == 0 or lk == 0:
        raise ValueError(f"flash_attention_bld: head dim {d} is not "
                         f"{_BLD_HEAD_DIM} or empty sequence (lq={lq}, lk={lk})")
    if not all(t.is_contiguous() and t.device == q.device and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention_bld: q/k/v must be contiguous and "
                         "16-byte aligned on one device")
    lib = _lib()
    o = torch.empty_like(q)
    rc = lib.svol_flash_attention_bld(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, num_heads,
        lq, lk, d, _in_dtype(scale, q.dtype), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash_attention_bld launch failed: "
                           + lib.svol_error_string(rc).decode())
    flash_attention_bld.launches += 1
    return o


flash_attention_bld.launches = 0
# the JAX package's public name for the same entry
flash_self_attention_bld = flash_attention_bld


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel (with the row logsumexp when a gradient will be
    asked for) or, on the CPU, the plain version. Backward:
    ``flash_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.device.type == "cpu":
            o, lse = attention_reference(q, k, v, scale), None
        else:
            o, lse = _forward_kernel(q, k, v, scale,
                                     with_lse=any(ctx.needs_input_grad[:3]))
        ctx.save_for_backward(q, k, v, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, lse, g.contiguous(),
                                              ctx.scale)
        return dq, dk, dv, None


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if not getattr(lib, "_svol_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.svol_flash_attention.argtypes = [p, p, p, p, p, i, i, i, i,
                                             ctypes.c_float, i, i, p]
        lib.svol_flash_attention.restype = i
        lib.svol_flash_attention_bld.argtypes = [p, p, p, p, i, i, i, i, i,
                                                 ctypes.c_float, i, p]
        lib.svol_flash_attention_bld.restype = i
        lib.svol_error_string.argtypes = [i]
        lib.svol_error_string.restype = ctypes.c_char_p
        lib._svol_typed = True
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_bwd")
    if not getattr(lib, "_svol_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.svol_flash_attention_bwd.argtypes = [p, p, p, p, p, p, p, p, p,
                                                 i, i, i, i, f, f, i, p]
        lib.svol_flash_attention_bwd.restype = i
        lib.svol_error_string.argtypes = [i]
        lib.svol_error_string.restype = ctypes.c_char_p
        lib._svol_typed = True
    return lib
