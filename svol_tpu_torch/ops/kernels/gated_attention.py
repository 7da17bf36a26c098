"""Gated sketch->video cross-attention: head-averaged attention weights of
one sketch query over the video tokens, used as a gate on the video stream.

Port of svol_tpu/ops/pallas/gated_attention.py. The kernel,
``csrc/gated_attention.cu``, computes the k-projection, the per-head
logits, the softmax over L, the head mean and the gating multiply in one
launch per batch (one block per batch row). Its gradient is autograd
through ``gated_attention_reference``, recomputed from the saved inputs,
as the JAX package's ``_fused_bwd`` does: no backward kernel.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from svol_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEADS = (1, 2, 4, 8)
_MAX_SMEM_BYTES = 232_448  # what one Hopper block may use


def gated_attention_reference(sketch, k_input, mem, wq, bq, wk, bk,
                              num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, mirroring the JAX ``gated_attention_reference``:
    the projections run in the promoted dtype of activations and weights,
    logits and softmax in f32, and the gate is cast to mem's dtype.
    Returns (att (B, L), gated (B, L, D))."""
    B, L, D = k_input.shape
    hd = D // num_heads
    ct = torch.promote_types(sketch.dtype, wq.dtype)
    q = torch.matmul(sketch.to(ct), wq.to(ct)) + bq.to(ct)  # (B, 1, D)
    k = torch.matmul(k_input.to(ct), wk.to(ct)) + bk.to(ct)  # (B, L, D)
    qh = q.reshape(B, num_heads, hd) * float(torch.tensor(hd ** -0.5, dtype=ct))
    kh = k.reshape(B, L, num_heads, hd)
    logits = torch.einsum("blhe,bhe->blh", kh.float(), qh.float())
    w = torch.softmax(logits, dim=1)  # over L
    g = w.mean(dim=-1)  # (B, L)
    out = mem * g[..., None].to(mem.dtype)
    return g.to(mem.dtype), out


def gated_attention(sketch, k_input, mem, wq, bq, wk, bk,
                    num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(att (B, L), gated (B, L, D)) in mem's dtype. ``sketch`` is (B, 1, D),
    ``k_input`` and ``mem`` (B, L, D), ``wq``/``wk`` (D, D) in (in, out)
    layout. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise. Differentiable (see ``_GatedAttention``)."""
    if mem.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gated_attention: unsupported device {mem.device}")
    return _GatedAttention.apply(sketch, k_input, mem, wq, bq, wk, bk, num_heads)


def _forward_kernel(sketch, k_input, mem, wq, bq, wk, bk, num_heads: int):
    acts, weights = (sketch, k_input, mem), (wq, bq, wk, bk)
    if mem.dtype not in _DTYPES or any(t.dtype != mem.dtype for t in acts):
        raise TypeError("gated_attention: sketch/k_input/mem must share "
                        "float32 or bfloat16")
    if any(t.dtype != torch.float32 for t in weights):
        raise TypeError("gated_attention: projection weights must be float32")
    B, L, D = mem.shape
    if (k_input.shape != mem.shape or sketch.shape != (B, 1, D)
            or wq.shape != (D, D) or wk.shape != (D, D)
            or bq.shape != (D,) or bk.shape != (D,)):
        raise ValueError("gated_attention: bad shapes")
    if num_heads not in _HEADS or D % num_heads or D % 32:
        raise ValueError(f"gated_attention: {num_heads} heads over D={D} "
                         f"not supported")
    if not all(t.is_contiguous() and t.device == mem.device
               for t in acts + weights):
        raise ValueError("gated_attention: inputs must be contiguous on one device")
    lib = _lib()
    if lib.svol_gated_attention_smem_bytes(L, D, num_heads) > _MAX_SMEM_BYTES:
        raise ValueError(f"gated_attention: L={L} too long for one block")
    att = torch.empty((B, L), dtype=mem.dtype, device=mem.device)
    out = torch.empty_like(mem)
    rc = lib.svol_gated_attention(
        sketch.data_ptr(), k_input.data_ptr(), mem.data_ptr(), wq.data_ptr(),
        bq.data_ptr(), wk.data_ptr(), bk.data_ptr(), att.data_ptr(),
        out.data_ptr(), B, L, D, num_heads, (D // num_heads) ** -0.5,
        _DTYPES[mem.dtype], torch.cuda.current_stream(mem.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("gated_attention launch failed: "
                           + lib.svol_error_string(rc).decode())
    gated_attention.launches += 1
    return att, out


gated_attention.launches = 0


class _GatedAttention(torch.autograd.Function):
    """Forward: the kernel or, on the CPU, the plain version. Backward:
    autograd of ``gated_attention_reference`` recomputed from the saved
    inputs (the JAX ``_fused_bwd``)."""

    @staticmethod
    def forward(ctx, sketch, k_input, mem, wq, bq, wk, bk, num_heads):
        args = (sketch, k_input, mem, wq, bq, wk, bk)
        ctx.save_for_backward(*args)
        ctx.num_heads = num_heads
        if mem.device.type == "cpu":
            return gated_attention_reference(*args, num_heads)
        return _forward_kernel(*args, num_heads)

    @staticmethod
    def backward(ctx, g_att, g_out):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            att, out = gated_attention_reference(*inputs, ctx.num_heads)
            grads = iter(torch.autograd.grad((att, out), wanted, (g_att, g_out)))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs) + (None,)


def _lib() -> ctypes.CDLL:
    lib = build.load("gated_attention")
    if not getattr(lib, "_svol_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.svol_gated_attention.argtypes = [p, p, p, p, p, p, p, p, p,
                                             i, i, i, i, ctypes.c_float, i, p]
        lib.svol_gated_attention.restype = i
        lib.svol_gated_attention_smem_bytes.argtypes = [i, i, i]
        lib.svol_gated_attention_smem_bytes.restype = ctypes.c_size_t
        lib.svol_error_string.argtypes = [i]
        lib.svol_error_string.restype = ctypes.c_char_p
        lib._svol_typed = True
    return lib
