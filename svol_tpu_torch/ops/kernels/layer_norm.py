"""Row LayerNorm over the last axis: f32 mean and biased two-pass variance,
eps inside the rsqrt, then scale and bias, cast back to x's dtype.

Port of svol_tpu/ops/pallas/layer_norm.py: the forward of ``_kernel`` (via
``fused_layer_norm``) is the hand-written CUDA kernel
``csrc/layer_norm.cu``, one warp per row. Forward only on the card: the
training slice of the port's ViT brings its backward (the JAX package
takes the VJP of ``layer_norm_reference``). ``FusedLayerNorm`` is the
module the port's ViT runs for every LayerNorm.
"""
from __future__ import annotations

import ctypes

import torch
from torch import nn

from svol_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DIM = 1024


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain PyTorch version, mirroring the JAX ``layer_norm_reference``."""
    xf = x.float()
    m = xf.mean(dim=-1, keepdim=True)
    var = (xf - m).square().mean(dim=-1, keepdim=True)
    y = (xf - m) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def fused_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm of ``x`` (any leading shape) over its last axis, in x's
    dtype. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_norm: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias)):
        raise NotImplementedError(
            "fused_layer_norm: the kernel is forward only; its backward comes "
            "with the ViT training slice of the port")
    d = x.shape[-1]
    vec = 16 // x.element_size() if x.dtype in _DTYPES else 1
    if x.dtype not in _DTYPES or weight.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"fused_layer_norm: x {x.dtype} {tuple(x.shape)}, "
                         f"weight {tuple(weight.shape)}, bias {tuple(bias.shape)}")
    if d % vec or d > _MAX_DIM:
        raise ValueError(f"fused_layer_norm: last axis {d} must be a multiple "
                         f"of {vec} and at most {_MAX_DIM}")
    if not all(t.device == x.device for t in (weight, bias)):
        raise ValueError("fused_layer_norm: weight/bias must be on x's device")
    # rows of a strided view (the CLS rows x[:, :1]) are read in place
    x2 = x.reshape(-1, d)
    if x2.stride(1) != 1 or x2.stride(0) % vec or x2.data_ptr() % 16:
        x2 = x2.contiguous()
    w = weight.float().contiguous()
    b = bias.float().contiguous()
    y = torch.empty((x2.shape[0], d), dtype=x.dtype, device=x.device)
    lib = _lib()
    rc = lib.svol_layer_norm(x2.data_ptr(), w.data_ptr(), b.data_ptr(),
                             y.data_ptr(), x2.shape[0], d, x2.stride(0), eps,
                             _DTYPES[x.dtype],
                             torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("layer_norm launch failed: "
                           + lib.svol_error_string(rc).decode())
    fused_layer_norm.launches += 1
    return y.reshape(x.shape)


fused_layer_norm.launches = 0


class FusedLayerNorm(nn.Module):
    """LayerNorm with float32 ``weight`` and ``bias`` (D,), the names the
    flax ``scale``/``bias`` map to. ``use_kernel`` runs ``fused_layer_norm``
    (the kernel on the card), otherwise ``layer_norm_reference``."""

    def __init__(self, dim: int, eps: float, use_kernel: bool = True):
        super().__init__()
        self.eps = eps
        self.use_kernel = use_kernel
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = fused_layer_norm if self.use_kernel else layer_norm_reference
        return fn(x, self.weight, self.bias, self.eps)


def _lib() -> ctypes.CDLL:
    lib = build.load("layer_norm")
    if not getattr(lib, "_svol_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.svol_layer_norm.argtypes = [p, p, p, p, i, i, ctypes.c_longlong,
                                        ctypes.c_float, i, p]
        lib.svol_layer_norm.restype = i
        lib.svol_error_string.argtypes = [i]
        lib.svol_error_string.restype = ctypes.c_char_p
        lib._svol_typed = True
    return lib
