"""Int8 convolution and calibration for the serving path (port of
svol_tpu/ops/quant.py).

Scheme, as in the JAX package:
  * weights: symmetric per-output-channel int8, max |w| over (cin, kh, kw)
    of each output channel / 127;
  * activations: symmetric per-tensor int8, with a dynamic scale (max |x| /
    127 of this call) or a static one from a calibration pass (``amax``);
  * products accumulate in int32 and are dequantized by ascale * wscale.
Every step runs in float32 whatever the compute dtype, in the JAX order:
ascale = max(amax, 1e-8) / 127, round(x / ascale) half to even, clip to
+-127, int32 accumulation, acc * (ascale * wscale), then the output dtype.

The port's convolutions are NCHW (with channels-last strides) over OIHW
kernels, so these functions take that layout. The int8 product is not a
Pallas kernel in the JAX package (XLA's int8 convolution), so on the card
it goes to a library int8 GEMM: an im2col of the int8 activations times the
int8 kernel through ``torch._int_mm`` (cuBLASLt, int32 accumulation). On
the CPU a float64 convolution of the int8 values gives the same int32
accumulators exactly (|acc| <= 127^2 * cin * kh * kw, far below 2^53).

Calibration (``calibrate_scales``): modules with a ``calibrating`` flag
record the running abs-max of their int8 inputs into scalar buffers while
computing the exact float output; those buffers then select static scales.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# buffer names of calibrated abs-max statistics: a conv's input, an
# attention's projected q, k and v (the flax ``quant`` collection's leaves)
SCALE_NAMES = ("amax", "amax_q", "amax_k", "amax_v")
# torch._int_mm takes K and N in multiples of 8: im2col pads the channels
_MM_ALIGN = 8


def quant_scale(amax: torch.Tensor) -> torch.Tensor:
    """f32 step of a symmetric int8 grid for abs-max ``amax``."""
    return torch.clamp(amax.float(), min=1e-8) / 127.0


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale) half to even, clipped to +-127, as int8."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)


def quantize_weights(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW float kernel -> (int8 kernel, f32 per-output-channel scale (O,))."""
    k = kernel.float()
    wscale = quant_scale(k.abs().amax(dim=(1, 2, 3)))
    return quantize(k, wscale[:, None, None, None]), wscale


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def im2col(xq: torch.Tensor, kernel_size: Sequence[int], stride, padding) -> torch.Tensor:
    """(N, C, H, W) int8 with channels-last strides -> (N * Ho * Wo,
    kh * kw * C8) int8 patches, C8 the channels zero padded to a multiple
    of 8, the columns in (kh, kw, c) order. The gather moves 32-bit words
    of four channels each, and each copy reads whole channel rows."""
    kh, kw = kernel_size
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    c = xq.shape[1]
    x = F.pad(xq.permute(0, 2, 3, 1), (0, -c % _MM_ALIGN, pw, pw, ph, ph))  # NHWC
    patches = x.view(torch.int32).unfold(1, kh, sh).unfold(2, kw, sw)
    n, ho, wo = patches.shape[:3]  # (N, Ho, Wo, C8 / 4, kh, kw)
    cols = patches.permute(0, 1, 2, 4, 5, 3).reshape(n * ho * wo, -1)
    return cols.view(torch.int8)


def im2col_weight(wq: torch.Tensor) -> torch.Tensor:
    """OIHW int8 kernel -> (O, kh * kw * C8) rows in ``im2col``'s column
    order."""
    w = F.pad(wq, (0, 0, 0, 0, 0, -wq.shape[1] % _MM_ALIGN))
    return w.permute(0, 2, 3, 1).reshape(wq.shape[0], -1)


def conv_i32(xq: torch.Tensor, wq: torch.Tensor, stride, padding) -> torch.Tensor:
    """Exact int32 accumulators of an int8 NCHW x OIHW convolution, NCHW
    (channels-last strides on the card)."""
    if xq.device.type == "cpu":
        return F.conv2d(xq.double(), wq.double(), stride=stride,
                        padding=padding).to(torch.int32)
    n, _, h, w = xq.shape
    o, _, kh, kw = wq.shape
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    ho, wo = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    a = im2col(xq, (kh, kw), stride, padding)
    acc = torch._int_mm(a, im2col_weight(wq).t())  # (N * Ho * Wo, O)
    return acc.view(n, ho, wo, o).permute(0, 3, 1, 2)


def int8_conv(x: torch.Tensor, kernel: torch.Tensor, stride, padding,
              out_dtype: Optional[torch.dtype] = None,
              static_amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NCHW x OIHW int8 convolution. Activation scale: this call's abs-max,
    or a calibrated ``static_amax`` (a scalar tensor)."""
    xf = x.float()
    amax = xf.abs().amax() if static_amax is None else static_amax
    ascale = quant_scale(amax)
    wq, wscale = quantize_weights(kernel)
    acc = conv_i32(quantize(xf, ascale), wq, stride, padding)
    # float(acc) * s in float32, rounded once to the output dtype; serving
    # only, so the scales carry no gradient
    out = torch.empty_like(acc, dtype=out_dtype or x.dtype)
    scale = (ascale * wscale).detach()[None, :, None, None]
    return torch.mul(acc, scale, out=out)


def record_amax(module: nn.Module, name: str, x: torch.Tensor) -> None:
    """Calibration: buffer ``name`` of ``module`` <- max(itself, max |x|)."""
    amax = x.detach().float().abs().amax()
    prev = getattr(module, name)
    setattr(module, name, amax if prev is None else torch.maximum(prev, amax))


def quant_scales(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The calibrated abs-max entries of a ``state_dict``."""
    return {k: v for k, v in state.items() if k.rsplit(".", 1)[-1] in SCALE_NAMES}


def load_quant_scales(model: nn.Module, scales: Mapping[str, torch.Tensor]) -> None:
    """Set the abs-max buffers named in ``scales`` (state-dict names), which
    switches those modules to static scales."""
    for key, value in scales.items():
        mod, name = key.rsplit(".", 1)
        if name not in SCALE_NAMES:
            raise KeyError(f"{key} is not a quantization scale")
        module = model.get_submodule(mod)
        if not hasattr(module, name):
            raise KeyError(f"{mod} holds no {name}")
        setattr(module, name, torch.as_tensor(value, dtype=torch.float32).to(
            next(model.parameters()).device).clone())


_INPUTS = ("src_sketch", "src_video", "src_sketch_mask", "src_video_mask")


@torch.no_grad()
def calibrate_scales(model: nn.Module, batches: Iterable[Mapping[str, torch.Tensor]],
                     max_batches: int = 8) -> Dict[str, torch.Tensor]:
    """Record per-tensor abs-max statistics for static int8 scales.

    Runs the eval-mode model (built with ``quantize='int8'``) on up to
    ``max_batches`` batches (dicts holding the model's inputs on its device;
    other keys are ignored) with every quantizable module in calibration
    mode: each records the running abs-max of its int8 inputs while
    computing the exact float output, so the statistics carry no upstream
    quantization error. The buffers stay on the model, whose later eval
    forwards then use static scales; returns them by state-dict name."""
    mods = [m for m in model.modules() if hasattr(m, "calibrating")]
    if not mods:
        raise ValueError("calibration needs a model built with quantize='int8'")
    model.eval()
    n = 0
    try:
        for m in mods:
            m.calibrating = True
        for batch in batches:
            if n >= max_batches:
                break
            model(**{k: batch[k] for k in _INPUTS})
            n += 1
    finally:
        for m in mods:
            m.calibrating = False
    if n == 0:
        raise ValueError("calibration got zero batches")
    return quant_scales(model.state_dict())
