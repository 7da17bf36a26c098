#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py [--seed 0] [--requests 32] [--profile]

Phases (each failure exits non-zero; nothing is swallowed):
  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build: compile svol_tpu_torch/csrc/*.cu with nvcc (one process per
     source, all started together);
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, in float32 (TF32 off) and bfloat16, at the flagship shapes
     (B = 8): flash attention at L = 1568 and L = 320, gated attention at
     L = 1568, D = 256 for every head count it is built for (the flagship
     runs H = 8); times at the flagship shapes of kernel, plain version and (flash)
     torch's scaled_dot_product_attention, beside a bound from bytes and
     operations;
  4. end to end: the flagship model (full width, random weights from
     --seed) in float32 with the kernels against the same model on its
     plain paths, on two clips;
  5. serve: export the bf16 flagship, start the port's HTTP server on
     localhost with batch size 8, send --requests clips from 16
     concurrent client threads (enough to fill batches of 8), check every
     response against a direct predict of the same clip, and check the
     launch counters: 4 flash and 2 gated launches per dispatched batch;
  6. (--profile) kernel time by name over one batch-8 predict;
  7. train kernels: at the flagship train shapes (B = 16), in float32 (TF32
     off) and bfloat16, the flash-attention backward against its plain
     version at L = 1568 and L = 320 (BH = 128), and the batched LSAP
     against its plain version and scipy on 512 random and 512 masked
     10 x 10 problems (assignments identical); times of kernel, plain
     version and (flash) torch's SDPA backward or (LSAP) scipy on the host,
     beside a bound from bytes and operations;
  8. train end to end: one float32 train step of the flagship at B = 2,
     kernels against the plain paths (losses, every gradient);
  9. train: the bf16 flagship at B = 16 (random weights from --seed) takes
     N_TRAIN_STEPS (20) AdamW steps on batches made from the seed; every
     loss and grad_norm finite, the launch counters at 4 flash forward, 4
     flash backward, 2 gated and 2 LSAP launches per step, one more step under
     torch.cuda.set_sync_debug_mode("error"); ms/step, frames/s, peak memory;
 10. (--profile) kernel time by name over one bf16 B = 16 train step;
 11. int8 kernel: the int8 attention kernel against its plain version at
     the serving shapes (BH = 64, L = 1568 and L = 320, q/k/v from bf16
     tensors quantized with dynamic and with static scales); times of
     kernel, plain version, the whole int8 attention function and, as the
     nearest library call, bf16 scaled_dot_product_attention, beside a
     bound from bytes, int8 operations and exponentials;
 12. int8 serve: the flagship with quantize='int8' and
     quantize_attention=True calibrated on one batch made from the seed,
     exported, served as in phase 5 (responses against direct predict, the
     /healthz quantize field), the launch counters at 2 int8 attention
     launches at each of L = 1568 and L = 320 and 2 gated launches per
     batch and no bf16 flash launch, and the int8 predict held near the f32
     predict of the same weights; (--profile) kernel time by name over one
     int8 batch-8 predict;
 13. ViT kernels: in float32 (TF32 off) and bfloat16, the (B, L, D) flash
     attention against its plain version at the ViT-B/16 shapes (B = 256
     frames and 8 sketches, L = 197, D = 768, H = 12) and the LayerNorm
     kernel against its plain version at (50,432, 768) rows and at the
     CLS-only rows (8, 1, 768) of a (8, 197, 768) tensor, eps 1e-12; the
     head's flash attention (L = 32) and gated attention (L = 32) at the
     ViT head's shapes; times of kernel, plain version and the nearest
     library call (scaled_dot_product_attention on a head-major copy, made
     outside the timed window; torch.nn.functional.layer_norm), beside a
     bound from bytes and operations;
 14. ViT end to end: the flagship head over the full-width ViT-B/16
     backbone in float32 with its kernels against the same model on its
     plain paths, on two clips;
 15. ViT serve: the bf16 ViT flagship exported and served as in phase 5,
     the launch counters at 24 (B, L, D) flash, 50 LayerNorm, 2 + 2 flash
     (L = 32 and L = 320) and 2 gated launches per batch, no L = 1568
     flash launch; peak memory of the direct predict; (--profile) kernel
     time by name over one ViT batch-8 predict.
It prints the card's name and power limit, a {"kernels": [...]} line and,
last, {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense; f32 off the tensor cores
# flash, per element: |kernel - plain| <= FLASH_RTOL * |plain| + FLASH_ATOL.
# f32: the repo's f32 attention tolerance. bf16: each side rounds its own
# f32 result to bf16 once, so the two may land a bf16 ulp or two apart
# (one ulp is at most 2^-7 of the value); the f32 results themselves differ
# because the kernel rounds unnormalized weights to bf16 and the plain
# version normalized ones, ~2^-9 * sqrt(e / L) (under 2e-4 at these shapes,
# where N(0, 1) logits make outputs of typical size sqrt(e / L): 0.04 at
# L = 1568, 0.09 at L = 320), which the atol of 2^-9 covers near zero.
FLASH_RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -6}
FLASH_ATOL = {"float32": 2e-5, "bfloat16": 2.0 ** -9}
# gated: relative to max |plain| — the kernel folds q into Wk and sums in
# another order; in bf16 both round g and the gated product once.
GATED_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
# scores/boxes of a served clip against a direct predict of it: one batch's
# rows are independent, so only algorithm choices of the bf16 forward differ
SERVE_ATOL = 5e-3
# f32 end to end, kernels vs plain paths: tests/test_full_model_parity.py's
E2E_ATOL = 1e-4
# concurrent clients of the serve phase: two batches' worth, so that a
# batch of 8 can fill while the previous one runs
CLIENTS = 16
# flash backward, per element: |kernel - plain| <= BWD_RTOL * |plain| +
# BWD_ATOL * rms(plain). f32: the repo's f32 attention tolerance, absolute
# (dq, dk and dv are ~0.025 at these shapes). bf16: two bf16 ulps (an ulp
# is at most 2^-7 of the value) plus 2^-6 of the rms. Each side rounds its
# f32 result to bf16 once, so they may land one ulp apart; before that the
# two differ only by f32 rounding (w rebuilt as exp(s - lse) against a
# softmax, sums in another order), which now and then flips the bf16
# rounding of one dl = w * (g v^T - delta) term: under 1e-3 of the rms
# summed over a row, or one more ulp where a single key dominates.
BWD_RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -6}
BWD_ATOL = {"float32": 2e-5, "bfloat16": 2.0 ** -6}
# f32 train step, kernels vs plain paths: the full-model loss tolerance and
# tests/test_full_model_parity.py's gradient tolerance
TRAIN_LOSS_ATOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
# launches per train step of the flagship (2 layers, final + 1 aux output):
# flash forward and backward at L = 1568 and L = 320 in each layer, the
# gated op in each layer, one LSAP per decoder output
PER_STEP = {"flash_long": 2, "flash_short": 2, "flash_backward": 4,
            "gated": 2, "lsap": 2}
N_TRAIN_STEPS = 20
# launches per served batch: flash at L = 1568 and L = 320 and the gated op
# in each of the 2 layers; in int8 the int8 attention takes both flash sites
PER_BATCH = {"flash_long": 2, "flash_short": 2, "gated": 2}
# with the ViT backbone: the (B, L, D) flash in each of the 12 encoder
# layers of 2 ViTs, 25 LayerNorms in each ViT (2 a layer and the final
# one), and the head's flash at L = T = 32 (one token per frame) and
# L = 320, both four threads a row, and the gated op
PER_BATCH_VIT = {"flash_short": 4, "gated": 2, "flash_bld": 24, "layer_norm": 50}
# LayerNorm kernel against plain version, per element: |kernel - plain| <=
# LN_RTOL * |plain| + LN_ATOL in f32: the two means are sums in other
# orders (a few ulps of the mean), and rsqrtf is within 2 ulps; in bf16 one
# bf16 ulp of the plain output more (each side rounds its f32 result once)
LN_RTOL, LN_ATOL = 2.0 ** -20, 1e-6
VIT_EPS = 1e-12
# flash in bf16 at L = 32, per element: |kernel - plain| <= 2^-8 (w |v| +
# |plain|) + 2e-5. Each side rounds every softmax weight to bf16 (the
# kernel unnormalized, the plain version normalized), which moves the
# output by at most 2^-9 w |v| each; each rounds its output once (2^-9
# |plain| each); the f32 arithmetic before differs by rounding (the f32
# attention tolerance). At L = 1568 and 320 the outputs are small and the
# rtol / atol above hold; at L = 32 a few keys carry each row.
FLASH_BF16_WEIGHT_ULPS = 2.0 ** -8
# gated in bf16: the two g (att) round to bf16 at most one ulp apart, and
# gated = mem g differs by mem times that ulp plus one rounding of its own
# (the kernel multiplies by its f32 g, the plain version by the bf16 one)
GATED_BF16_ULPS = 1.0
PER_BATCH_INT8 = {"gated": 2, "flash_int8": 4}
# int8 attention, kernel against plain version, per element:
# |kernel - plain| <= (L + 10) u |plain| + n / denom, u = 2^-24. Both take
# the same int8 tensors, so the int32 products are exact on each side; the
# exponentials are the same CUDA expf of the same f32 argument; the row
# sum denom of L positive terms runs in another order (at most L u apart,
# relatively), and four roundings on each side follow. n counts the row's
# weights e * 127 within 1e-4 of a half, which an ulp of exp could round
# apart: each moves the int32 accumulator by at most 127, the output by at
# most 1 / denom (the function's output is in units of v's int8 grid).
INT8_FLIP_WINDOW = 1e-4
# multi-function unit (exp2 and other f32 transcendentals) results per
# clock per SM on compute capability 9.0 (CUDA programming guide,
# arithmetic instruction throughput); expf is an ex2 after a multiply
SFU_PER_CLOCK_PER_SM = 16
PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core operations/s
# int8 serving against the f32 predict of the same weights, scores and
# boxes: int8 moves each of the ~36 conv inputs and the attention inputs by
# half a step of a 255-level grid, and bf16 compute adds its own rounding.
# The JAX suite bounds int8 against float at 0.5 on the logits
# (tests/test_quantize.py), which bounds softmax scores at 0.125 (a
# two-class softmax moves by at most 1/4 of its logit difference, which
# moves by at most twice the logits' bound); the small CPU model moved
# its scores by 0.013 and logits by 0.033 (tests/test_torch_port_int8.py).
# Expected here ~0.02 on scores and ~0.01 on boxes; the bound 0.1.
INT8_VS_F32_ATOL = 0.1


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_query(fields: str, fmt: str = "csv,noheader") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", f"--format={fmt}"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(out: str) -> str:
    """One line per kernel of nvcc's ``-Xptxas -v`` report: its (mangled)
    entry name, registers, shared memory and spills; anything else nvcc
    said (warnings) as it came."""
    lines, name, spills = [], None, ""
    for line in out.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and name is not None:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spills}")
            name = None
        elif "ptxas info" not in line and line.strip():
            lines.append(line)
    return "\n".join(lines)


def gpu_line() -> str:
    return gpu_query("name,power.limit")


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(torch, F, flash_mod, gated_mod, B: int, seed: int):
    """Phase 3. Returns {entry name: measurements} at the bf16 main path."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    results = {}
    hd, H, D = 32, 8, 256
    for L, key in ((1568, "flash_long"), (320, "flash_short")):
        BH = B * H
        scale = hd ** -0.5
        for dtype_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            q, k, v = (torch.randn(BH, L, hd, generator=gen, device=dev).to(dt)
                       for _ in range(3))
            got = flash_mod.flash_attention(q, k, v, scale).float()
            want = flash_mod.attention_reference(q, k, v, scale).float()
            torch.cuda.synchronize()
            diff = (got - want).abs()
            err = diff.max().item()
            limit = FLASH_RTOL[dtype_name] * want.abs() + FLASH_ATOL[dtype_name]
            worst = (diff / limit).max().item()
            log(f"flash L={L} {dtype_name}: max_abs_err={err:.3e}, max |plain| "
                f"{want.abs().max().item():.3e}, worst err/limit {worst:.3f} "
                f"(rtol {FLASH_RTOL[dtype_name]:.3e}, atol {FLASH_ATOL[dtype_name]:.3e})")
            if not worst <= 1.0:
                raise AssertionError(f"flash L={L} {dtype_name} disagrees: "
                                     f"err/limit {worst} > 1")
            if dtype_name != "bfloat16":
                continue
            ms = time_ms(torch, lambda: flash_mod.flash_attention(q, k, v, scale))
            plain = time_ms(torch, lambda: flash_mod.attention_reference(q, k, v, scale))
            q4, k4, v4 = (t.view(B, H, L, hd) for t in (q, k, v))
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale))
            nbytes = 2 * (2 * BH * L * hd + 2 * BH * L * hd)
            b, by = bound_ms(nbytes, 4 * BH * L * L * hd, dtype_name)
            log(f"flash L={L} bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"sdpa {lib:.4f} ms, bound {b:.4f} ms ({by})")
            results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                bound_ms=b, bound_by=by, library_ms=lib)

    L = 1568
    bound_w = (6.0 / (2 * D)) ** 0.5
    for heads, dtype_name, dt in ((h, n, t) for h in gated_mod._HEADS for n, t in
                                  (("float32", torch.float32), ("bfloat16", torch.bfloat16))):
        sketch = torch.randn(B, 1, D, generator=gen, device=dev).to(dt)
        kin = torch.randn(B, L, D, generator=gen, device=dev).to(dt)
        mem = torch.randn(B, L, D, generator=gen, device=dev).to(dt)
        wq, wk = ((torch.rand(D, D, generator=gen, device=dev) * 2 - 1) * bound_w
                  for _ in range(2))
        bq, bk = (0.1 * torch.randn(D, generator=gen, device=dev) for _ in range(2))
        args = (sketch, kin, mem, wq, bq, wk, bk, heads)
        att, out = gated_mod.gated_attention(*args)
        ref_att, ref_out = gated_mod.gated_attention_reference(*args)
        torch.cuda.synchronize()
        errs = [(a.float() - r.float()).abs().max().item() for a, r in
                ((att, ref_att), (out, ref_out))]
        tols = [GATED_RTOL[dtype_name] * r.float().abs().max().item()
                for r in (ref_att, ref_out)]
        log(f"gated H={heads} {dtype_name}: max_abs_err att={errs[0]:.3e} "
            f"(<= {tols[0]:.3e}), gated={errs[1]:.3e} (<= {tols[1]:.3e})")
        if not all(e <= t for e, t in zip(errs, tols)):
            raise AssertionError(f"gated H={heads} {dtype_name} disagrees: {errs} > {tols}")
        if dtype_name != "bfloat16" or heads != H:
            continue
        ms = time_ms(torch, lambda: gated_mod.gated_attention(*args))
        plain = time_ms(torch, lambda: gated_mod.gated_attention_reference(*args))
        e = 2
        nbytes = (B * D + 2 * B * L * D + B * L + B * L * D) * e + (2 * D * D + 2 * D) * 4
        flops = 4 * B * D * D + 2 * B * L * D * H + B * L * D + 4 * B * L * H
        b, by = bound_ms(nbytes, flops, "float32")
        log(f"gated bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {b:.4f} ms ({by})")
        results["gated"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain,
                                bound_ms=b, bound_by=by, library_ms=None)
    return results


def int8_limit(torch, qq, kq, logit_scale, plain):
    """Per-element limit of kernel against plain version (INT8 tolerance
    above), from the exact int8 logits."""
    L = kq.shape[1]
    # int8 products summed to at most 127^2 * 32 < 2^24: exact in f32
    s = torch.matmul(qq.float(), kq.float().transpose(-1, -2)) * logit_scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    del s
    t = e * 127.0
    near_half = ((t - t.floor() - 0.5).abs() < INT8_FLIP_WINDOW).sum(dim=-1, keepdim=True)
    del t
    denom = e.sum(dim=-1, keepdim=True)
    return (L + 10) * 2.0 ** -24 * plain.abs() + near_half / denom, int(near_half.sum())


def check_int8_kernels(torch, F, int8_mod, B: int, seed: int):
    """Phase 11. Returns {"flash_int8": measurements} at L = 1568."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    hd, H = 32, 8
    BH, scale = B * H, hd ** -0.5
    scale32 = float(torch.tensor(scale, dtype=torch.float32))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(gpu_query("clocks.max.sm", "csv,noheader,nounits")) * 1e6
    results = {}
    for L in (1568, 320):
        q, k, v = (torch.randn(BH, L, hd, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        for mode in ("dynamic", "static"):
            # static: abs-maxes 3/4 of this data's, as calibrated on other
            # clips; the top quarter clips
            amax = (None if mode == "dynamic"
                    else tuple(0.75 * t.float().abs().amax() for t in (q, k, v)))
            (qq, sq), (kq, sk), (vq, sv) = (
                int8_mod.quant_sym(t, None if amax is None else amax[i])
                for i, t in enumerate((q, k, v)))
            ls = (sq * sk * scale32).reshape(1)
            got = int8_mod.attention_int8(qq, kq, vq, ls)
            want = int8_mod.attention_int8_reference(qq, kq, vq, ls)
            torch.cuda.synchronize()
            limit, flips = int8_limit(torch, qq, kq, ls, want)
            diff = (got - want).abs()
            # a limit of 0 (a zero output in a row with no weight near a
            # half) admits only an equal output
            worst = torch.where(diff == 0, 0.0, diff / limit).max().item()
            err = diff.max().item()
            log(f"int8 attention L={L} {mode}: max_abs_err={err:.3e} (in v's int8 steps), "
                f"max |plain| {want.abs().max().item():.3e}, worst err/limit {worst:.3f} "
                f"(rtol (L + 10) 2^-24, {flips} weights near a half)")
            if not worst <= 1.0:
                raise AssertionError(f"int8 attention L={L} {mode} disagrees: "
                                     f"err/limit {worst} > 1")
            whole = time_ms(torch, lambda: int8_mod.flash_attention_int8(q, k, v, scale, amax))
            log(f"int8 attention L={L} {mode}: the whole function (quantize q/k/v, "
                f"kernel, v scale, bf16 out) {whole:.4f} ms")
            if mode != "dynamic":
                continue
            ms = time_ms(torch, lambda: int8_mod.attention_int8(qq, kq, vq, ls))
            plain = time_ms(torch, lambda: int8_mod.attention_int8_reference(qq, kq, vq, ls),
                            iters=5, warmup=1)
            q4, k4, v4 = (t.view(B, H, L, hd) for t in (q, k, v))
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale))
            # read int8 q, k, v and the f32 logit scale; write f32 out
            nbytes = 3 * BH * L * hd + 4 + 4 * BH * L * hd
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_int8 = 4 * BH * L * L * hd / PEAK_INT8_OPS * 1e3
            t_exp = BH * L * L / (sms * SFU_PER_CLOCK_PER_SM * clock_hz) * 1e3
            b = max(t_bytes, t_int8, t_exp)
            by = "bytes" if b == t_bytes else "operations"
            log(f"int8 attention L={L}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bf16 sdpa "
                f"{lib:.4f} ms; bound {b:.4f} ms ({by}: bytes {t_bytes:.4f}, int8 operations "
                f"{t_int8:.4f}, exponentials {t_exp:.4f} ms at {sms} SMs x "
                f"{SFU_PER_CLOCK_PER_SM}/clock x {clock_hz / 1e6:.0f} MHz)")
            if L == 1568:
                results["flash_int8"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                             bound_ms=b, bound_by=by, library_ms=lib)
        del q, k, v, qq, kq, vq, got, want, limit, diff
    log(f"int8 kernels measured on {gpu_line()}")
    return results


def check_end_to_end(torch, cfg_mod, model_mod, steps, seed: int):
    """Phase 4: f32 flagship forward, kernels on vs plain paths."""
    import numpy as np

    outs = []
    rng = np.random.default_rng(seed + 100)
    T, S = 32, 224
    batch = {
        "src_sketch": torch.from_numpy(rng.integers(0, 256, (2, 1, S, S, 3), dtype=np.uint8)).cuda(),
        "src_video": torch.from_numpy(rng.integers(0, 256, (2, T, S, S, 3), dtype=np.uint8)).cuda(),
        "src_sketch_mask": torch.ones(2, 1, device="cuda"),
        "src_video_mask": torch.tensor([[1.0] * T, [1.0] * (T - 4) + [0.0] * 4], device="cuda"),
    }
    for kernels in (True, False):
        cfg = cfg_mod.SvolConfig(model=cfg_mod.ModelConfig(
            compute_dtype="float32", use_flash_attention=kernels,
            use_pallas_attention=kernels))
        model = model_mod.SketchLocalizationModel(cfg).eval()
        model_mod.init_weights(model, torch.Generator().manual_seed(seed))
        outs.append(steps.make_predict_fn(model.cuda())(batch))
        del model
    err = max((a - b).abs().max().item() for a, b in zip(*outs))
    log(f"end to end f32, kernels vs plain paths: max_abs_err={err:.3e} (atol {E2E_ATOL:.0e})")
    if not err <= E2E_ATOL:
        raise AssertionError(f"end-to-end f32 disagrees: {err}")


def bf16_ulp(torch, x):
    """One bfloat16 spacing at |x| (8 significant bits)."""
    mag = x.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def check_vit_kernels(torch, F, flash_mod, gated_mod, ln_mod, seed: int):
    """Phase 13. Returns {entry name: measurements} at the bf16 ViT video
    shapes (B = 256 frames)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    dev = "cuda"
    results = {}
    L, D, H = 197, 768, 12
    hd = D // H
    scale = hd ** -0.5
    for B in (256, 8):
        for dtype_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            q, k, v = (torch.randn(B, L, D, generator=gen, device=dev).to(dt)
                       for _ in range(3))
            got = flash_mod.flash_attention_bld(q, k, v, scale, H).float()
            want = flash_mod.attention_bld_reference(q, k, v, scale, H).float()
            torch.cuda.synchronize()
            diff = (got - want).abs()
            err = diff.max().item()
            limit = FLASH_RTOL[dtype_name] * want.abs() + FLASH_ATOL[dtype_name]
            worst = (diff / limit).max().item()
            log(f"flash bld B={B} L={L} D={D} H={H} {dtype_name}: max_abs_err={err:.3e}, "
                f"max |plain| {want.abs().max().item():.3e}, worst err/limit {worst:.3f} "
                f"(rtol {FLASH_RTOL[dtype_name]:.3e}, atol {FLASH_ATOL[dtype_name]:.3e})")
            if not worst <= 1.0:
                raise AssertionError(f"flash bld B={B} {dtype_name} disagrees: "
                                     f"err/limit {worst} > 1")
            del got, want, diff, limit
            if dtype_name != "bfloat16":
                continue
            ms = time_ms(torch, lambda: flash_mod.flash_attention_bld(q, k, v, scale, H))
            plain = time_ms(torch, lambda: flash_mod.attention_bld_reference(
                q, k, v, scale, H), iters=5, warmup=1)
            # SDPA wants head-major operands: the copies are made here,
            # outside the timed window
            q4, k4, v4 = (t.view(B, L, H, hd).transpose(1, 2).contiguous()
                          for t in (q, k, v))
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale))
            nbytes = 2 * 4 * B * L * D  # bf16 q, k, v read, o written
            b, by = bound_ms(nbytes, 4 * B * H * L * L * hd, dtype_name)
            log(f"flash bld B={B} bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa on a "
                f"head-major copy {lib:.4f} ms, bound {b:.4f} ms ({by})")
            if B == 256:
                results["flash_bld"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                            bound_ms=b, bound_by=by, library_ms=lib)
            del q, k, v, q4, k4, v4

    for rows, cls_only in ((256 * L, False), (8, True)):
        for dtype_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            if cls_only:  # the CLS rows of (8, 197, 768), read in place
                x = torch.randn(rows, L, D, generator=gen, device=dev).to(dt)[:, :1]
            else:
                x = (2.0 * torch.randn(rows, D, generator=gen, device=dev) + 0.5).to(dt)
            w = 1.0 + 0.1 * torch.randn(D, generator=gen, device=dev)
            b_ = 0.1 * torch.randn(D, generator=gen, device=dev)
            got = ln_mod.fused_layer_norm(x, w, b_, VIT_EPS).float()
            want = ln_mod.layer_norm_reference(x, w, b_, VIT_EPS).float()
            torch.cuda.synchronize()
            diff = (got - want).abs()
            err = diff.max().item()
            limit = LN_RTOL * want.abs() + LN_ATOL
            if dtype_name == "bfloat16":
                limit = limit + bf16_ulp(torch, want)
            worst = (diff / limit).max().item()
            log(f"layer_norm {tuple(x.shape)} {dtype_name}: max_abs_err={err:.3e}, max |plain| "
                f"{want.abs().max().item():.3e}, worst err/limit {worst:.3f} (rtol "
                f"{LN_RTOL:.3e}, atol {LN_ATOL:.0e}" + (", + 1 bf16 ulp)" if dt ==
                                                         torch.bfloat16 else ")"))
            if not worst <= 1.0:
                raise AssertionError(f"layer_norm {tuple(x.shape)} {dtype_name} disagrees: "
                                     f"err/limit {worst} > 1")
            if dtype_name != "bfloat16" or cls_only:
                continue
            ms = time_ms(torch, lambda: ln_mod.fused_layer_norm(x, w, b_, VIT_EPS))
            plain = time_ms(torch, lambda: ln_mod.layer_norm_reference(x, w, b_, VIT_EPS))
            lib = time_ms(torch, lambda: F.layer_norm(x, (D,), w.to(dt), b_.to(dt), VIT_EPS))
            nbytes = 2 * 2 * rows * D + 2 * 4 * D
            b, by = bound_ms(nbytes, 8 * rows * D, "float32")
            log(f"layer_norm ({rows}, {D}) bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"F.layer_norm {lib:.4f} ms, bound {b:.4f} ms ({by})")
            results["layer_norm"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                         bound_ms=b, bound_by=by, library_ms=lib)
        del x, got, want, diff, limit

    # the head over ViT features: one token per frame, so its video
    # self-attention and the gated op run at L = T = 32, where few keys
    # carry each softmax: bf16 is held to limits derived per element from
    # the plain version (FLASH_BF16_WEIGHT_ULPS, GATED_BF16_ULPS)
    B, L, hd, Hh, Dh = 8, 32, 32, 8, 256
    BH = B * Hh
    bound_w = (6.0 / (2 * Dh)) ** 0.5
    for dtype_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        q, k, v = (torch.randn(BH, L, hd, generator=gen, device=dev).to(dt) for _ in range(3))
        got = flash_mod.flash_attention(q, k, v, hd ** -0.5).float()
        want = flash_mod.attention_reference(q, k, v, hd ** -0.5).float()
        if dt == torch.bfloat16:
            w = torch.softmax(torch.matmul((q * float(torch.tensor(hd ** -0.5, dtype=dt))).float(),
                                           k.float().transpose(-1, -2)), dim=-1)
            limit = FLASH_BF16_WEIGHT_ULPS * (torch.matmul(w, v.float().abs()) + want.abs()) \
                + FLASH_ATOL["float32"]
        else:
            limit = FLASH_RTOL[dtype_name] * want.abs() + FLASH_ATOL[dtype_name]
        f_diff = (got - want).abs()
        f_worst = (f_diff / limit).max().item()
        sketch = torch.randn(B, 1, Dh, generator=gen, device=dev).to(dt)
        kin, mem = (torch.randn(B, L, Dh, generator=gen, device=dev).to(dt) for _ in range(2))
        wq, wk = ((torch.rand(Dh, Dh, generator=gen, device=dev) * 2 - 1) * bound_w
                  for _ in range(2))
        bq, bk = (0.1 * torch.randn(Dh, generator=gen, device=dev) for _ in range(2))
        args = (sketch, kin, mem, wq, bq, wk, bk, Hh)
        (att, out), (r_att, r_out) = (gated_mod.gated_attention(*args),
                                      gated_mod.gated_attention_reference(*args))
        torch.cuda.synchronize()
        g_errs = [(a.float() - r.float()).abs() for a, r in ((att, r_att), (out, r_out))]
        if dt == torch.bfloat16:
            # g rounds to bf16 on each side (1 ulp apart at most); the
            # kernel multiplies mem by its f32 g, the plain version by the
            # rounded one, then each rounds the product
            u = bf16_ulp(torch, r_att.float())
            g_lims = [GATED_BF16_ULPS * u + 1e-6,
                      GATED_BF16_ULPS * (mem.float().abs() * u[..., None]
                                         + bf16_ulp(torch, r_out.float())) + 1e-6]
        else:
            g_lims = [GATED_RTOL[dtype_name] * r.float().abs().max()
                      for r in (r_att, r_out)]
        g_worst = [(e / lim).max().item() for e, lim in zip(g_errs, g_lims)]
        log(f"ViT head L={L} {dtype_name}: flash max_abs_err={f_diff.max().item():.3e} "
            f"(max |plain| {want.abs().max().item():.3e}, worst err/limit {f_worst:.3f}); "
            f"gated max_abs_err att={g_errs[0].max().item():.3e}, "
            f"gated={g_errs[1].max().item():.3e} (max |plain| "
            f"{r_att.float().abs().max().item():.3e}, {r_out.float().abs().max().item():.3e}; "
            f"worst err/limit {g_worst[0]:.3f}, {g_worst[1]:.3f})")
        if not (f_worst <= 1.0 and max(g_worst) <= 1.0):
            raise AssertionError(f"ViT head kernels at L={L} {dtype_name} disagree")
        if dtype_name != "bfloat16":
            continue
        f_ms = time_ms(torch, lambda: flash_mod.flash_attention(q, k, v, hd ** -0.5))
        f_plain = time_ms(torch, lambda: flash_mod.attention_reference(q, k, v, hd ** -0.5))
        q4, k4, v4 = (t.view(B, Hh, L, hd) for t in (q, k, v))
        f_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                                       scale=hd ** -0.5))
        f_b, f_by = bound_ms(2 * 4 * BH * L * hd, 4 * BH * L * L * hd, dtype_name)
        g_ms = time_ms(torch, lambda: gated_mod.gated_attention(*args))
        g_plain = time_ms(torch, lambda: gated_mod.gated_attention_reference(*args))
        nbytes = (B * Dh + 2 * B * L * Dh + B * L + B * L * Dh) * 2 + (2 * Dh * Dh + 2 * Dh) * 4
        flops = 4 * B * Dh * Dh + 2 * B * L * Dh * Hh + B * L * Dh + 4 * B * L * Hh
        g_b, g_by = bound_ms(nbytes, flops, "float32")
        log(f"ViT head L={L} bf16: flash kernel {f_ms:.4f} ms, plain {f_plain:.4f} ms, sdpa "
            f"{f_lib:.4f} ms, bound {f_b:.4f} ms ({f_by}); gated kernel {g_ms:.4f} ms, plain "
            f"{g_plain:.4f} ms, bound {g_b:.4f} ms ({g_by})")
    log(f"ViT kernels measured on {gpu_line()}")
    return results


def check_vit_end_to_end(torch, cfg_mod, model_mod, steps, seed: int):
    """Phase 14: the f32 ViT flagship, kernels on vs plain paths."""
    import numpy as np

    outs = []
    rng = np.random.default_rng(seed + 140)
    T, S = 32, 224
    batch = {
        "src_sketch": torch.from_numpy(rng.integers(0, 256, (2, 1, S, S, 3), dtype=np.uint8)).cuda(),
        "src_video": torch.from_numpy(rng.integers(0, 256, (2, T, S, S, 3), dtype=np.uint8)).cuda(),
        "src_sketch_mask": torch.ones(2, 1, device="cuda"),
        "src_video_mask": torch.tensor([[1.0] * T, [1.0] * (T - 4) + [0.0] * 4], device="cuda"),
    }
    for kernels in (True, False):
        cfg = cfg_mod.SvolConfig(model=cfg_mod.ModelConfig(
            backbone="vit", compute_dtype="float32", use_flash_attention=kernels,
            use_pallas_attention=kernels))
        model = model_mod.SketchLocalizationModel(cfg).eval()
        model_mod.init_weights(model, torch.Generator().manual_seed(seed))
        outs.append(steps.make_predict_fn(model.cuda())(batch))
        del model
    err = max((a - b).abs().max().item() for a, b in zip(*outs))
    log(f"ViT end to end f32, kernels vs plain paths: max_abs_err={err:.3e} "
        f"(atol {E2E_ATOL:.0e})")
    if not err <= E2E_ATOL:
        raise AssertionError(f"ViT end-to-end f32 disagrees: {err}")


def serve(torch, cfg_mod, model_mod, serving, serve_cli, synthetic, kernel_mods,
          B: int, n_requests: int, seed: int, quantize: bool = False,
          backbone: str = "resnet"):
    """Phase 5 (bf16), phase 12 (with ``quantize``: int8, calibrated on one
    batch made from the seed) or phase 15 (bf16 with the ViT backbone).
    Returns ({name: launches}, predict, a full batch, the model's state
    dict)."""
    import numpy as np

    from svol_tpu_torch.ops import quant

    cfg = cfg_mod.SvolConfig(model=cfg_mod.ModelConfig(
        use_pallas_attention=True, quantize="int8" if quantize else None,
        quantize_attention=quantize, backbone=backbone))
    T, S, Q = cfg.data.num_frames, cfg.data.image_size, cfg.model.num_queries
    L = T * model_mod.tokens_per_frame(cfg.model.backbone, S)
    vit = backbone == "vit"
    tag = "int8" if quantize else "ViT bf16" if vit else "bf16"
    model = model_mod.SketchLocalizationModel(cfg)
    model_mod.init_weights(model, torch.Generator().manual_seed(seed))
    if quantize:
        calib = synthetic.to_device(synthetic.sample_train_batch(cfg, B, seed=seed + 12),
                                    "cuda")
        t0 = time.perf_counter()
        scales = quant.calibrate_scales(model.cuda(), [calib])
        torch.cuda.synchronize()
        log(f"int8 calibration on one batch of {B}: {len(scales)} scales in "
            f"{time.perf_counter() - t0:.3f} s")
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    tmp = tempfile.TemporaryDirectory(prefix="svol_smoke_")
    try:
        export_dir = serving.export_model(cfg, state, os.path.join(tmp.name, "export"),
                                          batch_size=B)
        server, batcher, stats, port = serve_cli.start_server(
            export_dir, port=0, batch_timeout_ms=20.0, device="cuda")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        clips = []
        for i in range(n_requests):
            rng = np.random.default_rng(seed + 1 + i)
            clips.append({
                "src_video": rng.integers(0, 256, (T, S, S, 3), dtype=np.uint8),
                "src_sketch": rng.integers(0, 256, (1, S, S, 3), dtype=np.uint8),
            })
        bodies = []
        for clip in clips:
            buf = io.BytesIO()
            np.savez(buf, **clip)
            bodies.append(buf.getvalue())
        responses = [None] * n_requests
        errors = []

        def client(idx):
            try:
                for i in idx:
                    req = urllib.request.Request(
                        f"http://127.0.0.1:{port}/predict", data=bodies[i], method="POST")
                    with urllib.request.urlopen(req, timeout=300) as r:
                        responses[i] = (r.status, json.loads(r.read()))
            except Exception as e:  # reported below, then the phase fails
                errors.append(repr(e))

        try:
            zero_counts(*kernel_mods)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client,
                                        args=(range(c, n_requests, CLIENTS),))
                       for c in range(CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
            wall = time.perf_counter() - t0
            launches = read_counts(*kernel_mods)
            by_length = dict(kernel_mods[3].attention_int8.launches_by_length)
            flash_by_length = dict(kernel_mods[0].flash_attention.launches_by_length)
            if any(t.is_alive() for t in threads) or errors:
                raise RuntimeError(f"clients failed: {errors}")
            snap = stats.snapshot()
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
                health = json.loads(r.read())
        finally:
            server.shutdown()
            server.server_close()
            batcher.stop()
            thread.join(timeout=30)

        batches = snap["total_batches"]
        log(f"served {tag} {n_requests} requests in {batches} batches "
            f"(occupancy {snap['batch_occupancy']}), launches {launches}"
            + (f", int8 attention by length {by_length}" if quantize else ""))
        per = PER_BATCH_INT8 if quantize else PER_BATCH_VIT if vit else PER_BATCH
        want = {name: per.get(name, 0) * batches for name in launches}
        if launches != want or batches == 0:
            raise AssertionError(f"{tag} launch counts {launches} != {want}")
        if vit and flash_by_length != {L: 2 * batches, Q: 2 * batches}:
            raise AssertionError(f"ViT flash launches by length {flash_by_length}: "
                                 f"not 2 per batch at each of L = {L} and {Q}")
        if quantize and by_length != {L: 2 * batches, Q: 2 * batches}:
            raise AssertionError(f"int8 attention launches by length {by_length}: "
                                 f"not 2 per batch at each of L = {L} and {Q}")
        if health.get("quantize") != cfg.model.quantize:
            raise AssertionError(f"/healthz reports quantize {health.get('quantize')!r}")

        predict, meta = serving.load_exported(export_dir, device="cuda")
        if meta["quantize"] != cfg.model.quantize:
            raise AssertionError(f"meta.json quantize {meta['quantize']!r}")
        direct = []
        for i, (status, resp) in enumerate(responses):
            if status != 200:
                raise AssertionError(f"request {i}: HTTP {status}")
            scores = np.asarray(resp["scores"], np.float32)
            boxes = np.asarray(resp["boxes_xyxy"], np.float32)
            if scores.shape != (Q,) or boxes.shape != (Q, 4):
                raise AssertionError(f"request {i}: shapes {scores.shape}, {boxes.shape}")
            if not (np.isfinite(scores).all() and np.isfinite(boxes).all()):
                raise AssertionError(f"request {i}: non-finite output")
            frames = resp["frames"]
            if len(frames) != T or any(
                    [r[4] for r in f] != sorted((r[4] for r in f), reverse=True)
                    for f in frames):
                raise AssertionError(f"request {i}: frames not score-sorted per frame")
            batch = {
                "src_video": np.broadcast_to(clips[i]["src_video"], (B, T, S, S, 3)),
                "src_sketch": np.broadcast_to(clips[i]["src_sketch"], (B, 1, S, S, 3)),
                "src_video_mask": np.ones((B, T), np.float32),
                "src_sketch_mask": np.ones((B, 1), np.float32),
            }
            d_scores, d_boxes = predict(batch)
            direct.append(d_scores[0])
            err = max(np.abs(scores - d_scores[0]).max(), np.abs(boxes - d_boxes[0]).max())
            if not err <= SERVE_ATOL:
                raise AssertionError(f"request {i}: served vs direct predict {err} > {SERVE_ATOL}")
        spread = max(np.abs(direct[0] - d).max() for d in direct[1:])
        log(f"{tag}: every response matches a direct predict within {SERVE_ATOL}; "
            f"clips differ from each other by up to {spread:.3e}")

        lat = np.asarray([r[1]["latency_ms"] for r in responses])
        full = {k: np.stack([clips[i % n_requests][k] for i in range(B)])
                for k in ("src_video", "src_sketch")}
        full["src_video_mask"] = np.ones((B, T), np.float32)
        full["src_sketch_mask"] = np.ones((B, 1), np.float32)
        predict(full)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            predict(full)
        torch.cuda.synchronize()
        batch_s = (time.perf_counter() - t1) / reps
        peak = torch.cuda.max_memory_allocated()
        log(f"serve {tag}: p50 {np.percentile(lat, 50):.3f} ms, p90 "
            f"{np.percentile(lat, 90):.3f} ms, {n_requests * T / wall:.1f} frames/s over "
            f"{wall:.3f} s with {CLIENTS} clients, batch occupancy {snap['batch_occupancy']}; "
            f"direct batch-{B} predict {batch_s * 1e3:.3f} ms = {B * T / batch_s:.1f} frames/s, "
            f"peak memory {peak / 2**30:.3f} GiB (the server's model and this one)")
        log(f"serve {tag} measured on {gpu_line()}")
        return launches, predict, full, state
    finally:
        tmp.cleanup()


def check_int8_near_f32(torch, cfg_mod, model_mod, steps, state, predict, full) -> None:
    """Phase 12: the int8 predict against the f32 predict of the same
    weights (TF32 off), on the full batch."""
    import numpy as np

    from svol_tpu_torch.ops.quant import quant_scales

    cfg = cfg_mod.SvolConfig(model=cfg_mod.ModelConfig(
        compute_dtype="float32", use_pallas_attention=True))
    model = model_mod.SketchLocalizationModel(cfg).eval()
    model.load_state_dict({k: v for k, v in state.items() if k not in quant_scales(state)},
                          strict=True)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in full.items()}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        want = [t.cpu().numpy() for t in steps.make_predict_fn(model.cuda())(batch)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    got = predict(full)
    errs = [float(np.abs(g - w).max()) for g, w in zip(got, want)]
    means = [float(np.abs(g - w).mean()) for g, w in zip(got, want)]
    log(f"int8 predict vs f32 predict of the same weights: scores max {errs[0]:.3e} "
        f"(mean {means[0]:.3e}), boxes max {errs[1]:.3e} (mean {means[1]:.3e}), "
        f"bound {INT8_VS_F32_ATOL}")
    if not max(errs) <= INT8_VS_F32_ATOL:
        raise AssertionError(f"int8 predict strays from f32: {errs} > {INT8_VS_F32_ATOL}")


def profile(torch, predict, full) -> None:
    from torch.profiler import ProfilerActivity, profile as prof

    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        predict(full)
        torch.cuda.synchronize()
    log(p.key_averages().table(sort_by="cuda_time_total", row_limit=25))


def check_train_kernels(torch, F, flash_mod, lsap_mod, B: int, seed: int):
    """Phase 7. Returns {entry name: measurements} at the bf16 train shapes."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment

    from svol_tpu_torch.ops.hungarian import masked_cost_matrix

    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    dev = "cuda"
    results = {}
    hd, H = 32, 8
    BH, scale = B * H, hd ** -0.5
    for L in (1568, 320):
        for dtype_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            q, k, v, g = (torch.randn(BH, L, hd, generator=gen, device=dev).to(dt)
                          for _ in range(4))
            lse = flash_mod._forward_kernel(q, k, v, scale, with_lse=True)[1]
            got = flash_mod.flash_attention_backward(q, k, v, lse, g, scale)
            want = flash_mod.attention_backward_reference(q, k, v, g, scale)
            torch.cuda.synchronize()
            errs, worsts, ulps = [], [], []
            for a, b in zip(got, want):
                a, b = a.float(), b.float()
                diff = (a - b).abs()
                rms = b.pow(2).mean().sqrt()
                limit = BWD_RTOL[dtype_name] * b.abs() + BWD_ATOL[dtype_name] * (
                    rms if dtype_name == "bfloat16" else 1.0)
                errs.append(diff.max().item())
                worsts.append((diff / limit).max().item())
                # the difference in bf16 ulps of the plain value
                ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp(min=1e-30))) - 7)
                ulps.append((diff / ulp)[b.abs() > rms].max().item())
            log(f"flash backward L={L} {dtype_name}: max_abs_err dq/dk/dv "
                f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, worst err/limit "
                f"{max(worsts):.3f} (rtol {BWD_RTOL[dtype_name]:.3e}, atol "
                f"{BWD_ATOL[dtype_name]:.3e}{' x rms' if dtype_name == 'bfloat16' else ''})"
                + (f"; bf16 ulps at most {ulps[0]:.1f}/{ulps[1]:.1f}/{ulps[2]:.1f} "
                   "where the plain value is above the rms"
                   if dtype_name == "bfloat16" else ""))
            if not max(worsts) <= 1.0:
                raise AssertionError(f"flash backward L={L} {dtype_name} disagrees: "
                                     f"err/limit {worsts}")
            if dtype_name != "bfloat16":
                continue
            ms = time_ms(torch, lambda: flash_mod.flash_attention_backward(
                q, k, v, lse, g, scale))
            plain = time_ms(torch, lambda: flash_mod.attention_backward_reference(
                q, k, v, g, scale))
            q4, k4, v4 = (t.view(B, H, L, hd).detach().requires_grad_() for t in (q, k, v))
            out4 = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
            g4 = g.view(B, H, L, hd)
            lib = time_ms(torch, lambda: torch.autograd.grad(
                out4, (q4, k4, v4), g4, retain_graph=True))
            del out4
            e = 2
            # read q, k, v, g and the f32 logsumexp; write dq, dk, dv
            nbytes = 7 * BH * L * hd * e + BH * L * 4
            # the QK^T, dV, dP, dQ and dK products
            b, by = bound_ms(nbytes, 10 * BH * L * L * hd, dtype_name)
            log(f"flash backward L={L} bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"sdpa backward {lib:.4f} ms, bound {b:.4f} ms ({by})")
            if L == 1568:
                results["flash_backward"] = dict(
                    max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b,
                    bound_by=by, library_ms=lib)
            del q, k, v, g, lse, got, want

    # LSAP: the per-frame matcher's problems, W = B * T = 512 of 10 x 10
    W, n = B * 32, 10
    rng = np.random.default_rng(seed + 8)
    plain_cost = rng.normal(size=(W, n, n)).astype(np.float32)
    valid = np.arange(n) < rng.integers(0, n + 1, size=(W, 1))
    masked = masked_cost_matrix(
        torch.from_numpy(rng.uniform(size=(W, n, n)).astype(np.float32)).to(dev),
        torch.from_numpy(valid).to(dev)).contiguous()
    for name, cost in (("random", torch.from_numpy(plain_cost).to(dev)), ("masked", masked)):
        got = lsap_mod.lsap(cost)
        want, trips = lsap_mod.solve_dense_reference(cost, count_trips=True)
        got, want, host = got.cpu().numpy(), want.cpu().numpy(), cost.cpu().numpy()
        if not (got == want).all():
            raise AssertionError(f"LSAP {name}: kernel and plain version disagree on "
                                 f"{int((got != want).any(1).sum())} of {W} problems")
        t0 = time.perf_counter()
        scipy_cols = [linear_sum_assignment(c)[1] for c in host]
        scipy_ms = (time.perf_counter() - t0) * 1e3
        for w in range(W):
            if name == "random":
                same = (got[w] == scipy_cols[w]).all()
            else:  # the real columns' pairs are scipy's rectangular solution
                cols = np.flatnonzero(valid[w])
                r, c = linear_sum_assignment(host[w][:, cols])
                same = ({(i, int(cols[j])) for i, j in zip(r, c)}
                        == {(i, int(j)) for i, j in enumerate(got[w]) if valid[w][j]})
            if not same:
                raise AssertionError(f"LSAP {name}: problem {w} differs from scipy")
        log(f"LSAP {name} W={W} {n}x{n}: kernel, plain version and scipy agree on "
            f"every assignment; {int(trips.sum())} Dijkstra trips")
        if name != "random":
            continue
        ms = time_ms(torch, lambda: lsap_mod.lsap(cost), iters=100)
        plain = time_ms(torch, lambda: lsap_mod.solve_dense_reference(cost), iters=3, warmup=1)
        # read the costs, write col4row; per Dijkstra trip 3 adds and a
        # compare per column, then a 5-level argmin over 32 lanes
        nbytes = W * n * n * 4 + W * n * 4
        b, by = bound_ms(nbytes, int(trips.sum()) * (4 * n + 10), "float32")
        log(f"LSAP W={W} {n}x{n}: kernel {ms:.4f} ms, plain {plain:.4f} ms, scipy "
            f"on the host {scipy_ms:.4f} ms ({W} calls), bound {b:.6f} ms ({by})")
        results["lsap"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b,
                               bound_by=by, library_ms=None)
    return results


def _train_setup(torch, cfg_mod, model_mod, state_mod, criterion_mod, steps_mod,
                 cfg, seed: int):
    model = model_mod.SketchLocalizationModel(cfg)
    model_mod.init_weights(model, torch.Generator().manual_seed(seed))
    state = state_mod.create_train_state(cfg, model, device="cuda")
    step = steps_mod.make_train_step(cfg, criterion_mod.build_criterion(cfg))
    return state, step


def check_train_end_to_end(torch, cfg_mod, model_mod, state_mod, criterion_mod,
                           steps_mod, synthetic, seed: int):
    """Phase 8: one f32 train step at B = 2, kernels vs plain paths."""
    B = 2
    runs = []
    for kernels in (True, False):
        cfg = cfg_mod.SvolConfig(model=cfg_mod.ModelConfig(
            compute_dtype="float32", use_flash_attention=kernels,
            use_pallas_attention=kernels))
        batch = synthetic.to_device(synthetic.sample_train_batch(cfg, B, seed=seed + 9), "cuda")
        state, step = _train_setup(torch, cfg_mod, model_mod, state_mod, criterion_mod,
                                   steps_mod, cfg, seed)
        _, metrics = step(state, batch)
        grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
        runs.append(({k: v.item() for k, v in metrics.items()}, grads))
        del state, step
    (m_k, g_k), (m_p, g_p) = runs
    loss_err = max(abs(m_k[k] - m_p[k]) for k in m_p if k != "grad_norm")
    worst, worst_name = 0.0, ""
    for name, gp in g_p.items():
        r = ((g_k[name] - gp).abs() / (GRAD_ATOL + GRAD_RTOL * gp.abs())).max().item()
        if r > worst:
            worst, worst_name = r, name
    log(f"train step f32 B={B}, kernels vs plain paths: losses max_abs_err "
        f"{loss_err:.3e} (atol {TRAIN_LOSS_ATOL:.0e}); gradients worst err/limit "
        f"{worst:.3f} at {worst_name} (atol {GRAD_ATOL:.0e}, rtol {GRAD_RTOL:.0e}); "
        f"grad_norm {m_k['grad_norm']:.6f} vs {m_p['grad_norm']:.6f}")
    if not (loss_err <= TRAIN_LOSS_ATOL and worst <= 1.0):
        raise AssertionError("f32 train step: kernels and plain paths disagree")


def zero_counts(flash_mod, gated_mod, lsap_mod, int8_mod, ln_mod) -> None:
    flash_mod.flash_attention.launches = 0
    flash_mod.flash_attention.launches_short = 0
    flash_mod.flash_attention.launches_by_length = {}
    flash_mod.flash_attention_backward.launches = 0
    flash_mod.flash_attention_bld.launches = 0
    gated_mod.gated_attention.launches = 0
    lsap_mod.lsap.launches = 0
    int8_mod.attention_int8.launches = 0
    int8_mod.attention_int8.launches_by_length = {}
    ln_mod.fused_layer_norm.launches = 0


def read_counts(flash_mod, gated_mod, lsap_mod, int8_mod, ln_mod):
    fwd = flash_mod.flash_attention
    return {"flash_long": fwd.launches - fwd.launches_short,
            "flash_short": fwd.launches_short,
            "flash_backward": flash_mod.flash_attention_backward.launches,
            "gated": gated_mod.gated_attention.launches,
            "lsap": lsap_mod.lsap.launches,
            "flash_int8": int8_mod.attention_int8.launches,
            "flash_bld": flash_mod.flash_attention_bld.launches,
            "layer_norm": ln_mod.fused_layer_norm.launches}


def train_run(torch, cfg_mod, model_mod, state_mod, criterion_mod, steps_mod,
              synthetic, kernel_mods, B: int, seed: int):
    """Phase 9. Returns ({name: launches}, state, step, batch)."""
    n_steps = N_TRAIN_STEPS
    cfg = cfg_mod.SvolConfig(model=cfg_mod.ModelConfig(use_pallas_attention=True))
    T = cfg.data.num_frames
    state, step = _train_setup(torch, cfg_mod, model_mod, state_mod, criterion_mod,
                               steps_mod, cfg, seed)
    batches = [synthetic.to_device(synthetic.sample_train_batch(cfg, B, seed=seed + 10 + i),
                                   "cuda") for i in range(4)]
    for i in range(2):  # warm-up: cuDNN heuristics, the allocator
        step(state, batches[i])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(*kernel_mods)
    t0 = time.perf_counter()
    logged = [step(state, batches[i % len(batches)])[1] for i in range(n_steps)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts(*kernel_mods)
    peak = torch.cuda.max_memory_allocated()
    values = {k: torch.stack([m[k] for m in logged]).float().cpu() for k in logged[0]}
    if not all(torch.isfinite(v).all() for v in values.values()):
        raise AssertionError("train run: a loss or grad_norm is not finite")
    want = {name: PER_STEP.get(name, 0) * n_steps for name in launches}
    log(f"train run bf16 B={B}: {n_steps} steps in {secs:.3f} s = "
        f"{secs / n_steps * 1e3:.3f} ms/step, {B * T * n_steps / secs:.1f} training "
        f"frames/s, peak memory {peak / 2**30:.3f} GiB; launches {launches}")
    log("train run losses: loss_overall first/last "
        f"{values['loss_overall'][0]:.4f}/{values['loss_overall'][-1]:.4f}, grad_norm "
        f"first/last {values['grad_norm'][0]:.4f}/{values['grad_norm'][-1]:.4f}")
    if launches != want:
        raise AssertionError(f"train run launch counts {launches} != {want}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(state, batches[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("one train step ran under torch.cuda.set_sync_debug_mode('error'): "
        "no host synchronization")
    log(f"train measured on {gpu_line()}")
    return launches, state, step, batches[0]


def profile_train(torch, state, step, batch) -> None:
    from torch.profiler import ProfilerActivity, profile as prof

    step(state, batch)
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        step(state, batch)
        torch.cuda.synchronize()
    log(p.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    if args.requests < CLIENTS:
        ap.error(f"--requests must be at least {CLIENTS}")

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "svol_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from svol_tpu_torch import config as cfg_mod
    from svol_tpu_torch import serving
    from svol_tpu_torch.cli import serve as serve_cli
    from svol_tpu_torch.data import synthetic
    from svol_tpu_torch.losses import criterion as criterion_mod
    from svol_tpu_torch.models import model as model_mod
    from svol_tpu_torch.ops.kernels import build
    from svol_tpu_torch.ops.kernels import flash_attention as flash_mod
    from svol_tpu_torch.ops.kernels import flash_attention_int8 as int8_mod
    from svol_tpu_torch.ops.kernels import gated_attention as gated_mod
    from svol_tpu_torch.ops.kernels import layer_norm as ln_mod
    from svol_tpu_torch.ops.kernels import lsap as lsap_mod
    from svol_tpu_torch.train import state as state_mod
    from svol_tpu_torch.train import steps

    t_start = time.perf_counter()
    card = gpu_line()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}; {torch.cuda.get_device_name(0)}")
    log(f"nvidia-smi: {card}")

    secs = build.build()
    log(f"build: {secs:.1f} s")
    for name, out in sorted(build.build_log.items()):
        log(f"--- nvcc {name}.cu ---\n{ptxas_summary(out)}")

    B = 8
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        measured = check_kernels(torch, F, flash_mod, gated_mod, B, args.seed)
        check_end_to_end(torch, cfg_mod, model_mod, steps, args.seed)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    kernel_mods = (flash_mod, gated_mod, lsap_mod, int8_mod, ln_mod)
    launches, predict, full, _ = serve(torch, cfg_mod, model_mod, serving, serve_cli,
                                       synthetic, kernel_mods, B, args.requests, args.seed)
    if args.profile:
        profile(torch, predict, full)
    del predict, full

    # training at the config's batch, the JAX package's default (16)
    B_TRAIN = cfg_mod.DataConfig().bs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    measured.update(check_train_kernels(torch, F, flash_mod, lsap_mod, B_TRAIN, args.seed))
    check_train_end_to_end(torch, cfg_mod, model_mod, state_mod, criterion_mod, steps,
                           synthetic, args.seed)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    trained = train_run(torch, cfg_mod, model_mod, state_mod, criterion_mod, steps,
                        synthetic, kernel_mods, B_TRAIN, args.seed)
    train_launches = trained[0]
    if args.profile:
        profile_train(torch, *trained[1:])
    del trained
    torch.cuda.empty_cache()

    # int8 serving: its kernel at the serving shapes, then the path
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        measured.update(check_int8_kernels(torch, F, int8_mod, B, args.seed))
    torch.backends.cuda.matmul.allow_tf32 = tf32[0]
    torch.cuda.empty_cache()
    int8_launches, predict, full, state = serve(
        torch, cfg_mod, model_mod, serving, serve_cli, synthetic, kernel_mods, B,
        args.requests, args.seed, quantize=True)
    check_int8_near_f32(torch, cfg_mod, model_mod, steps, state, predict, full)
    if args.profile:
        profile(torch, predict, full)
    del predict, full, state
    torch.cuda.empty_cache()

    # the ViT backbone: its kernels at the ViT shapes, f32 end to end, then
    # the served bf16 path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        measured.update(check_vit_kernels(torch, F, flash_mod, gated_mod, ln_mod, args.seed))
        torch.cuda.empty_cache()
        check_vit_end_to_end(torch, cfg_mod, model_mod, steps, args.seed)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    vit_launches, predict, full, _ = serve(
        torch, cfg_mod, model_mod, serving, serve_cli, synthetic, kernel_mods, B,
        args.requests, args.seed, backbone="vit")
    if args.profile:
        profile(torch, predict, full)
    del predict, full

    # launches: the served bf16 run's, the train run's, the served int8
    # run's and the served ViT run's, each counted from 0 just before its
    # path ran
    entries = [
        ("flash_attention (video self-attention, L=1568)", "flash_long",
         "svol_tpu_torch/csrc/flash_attention.cu", "svol_tpu/ops/pallas/flash_attention.py:167"),
        ("flash_attention (query self-attention, L=320)", "flash_short",
         "svol_tpu_torch/csrc/flash_attention.cu", "svol_tpu/ops/pallas/flash_attention.py:153"),
        ("gated_attention", "gated",
         "svol_tpu_torch/csrc/gated_attention.cu", "svol_tpu/ops/pallas/gated_attention.py:112"),
        ("flash_attention_backward (L=1568; also L=320)", "flash_backward",
         "svol_tpu_torch/csrc/flash_attention_bwd.cu",
         "svol_tpu/ops/pallas/flash_attention.py:256"),
        ("lsap (batched Jonker-Volgenant, 512 x 10 x 10)", "lsap",
         "svol_tpu_torch/csrc/lsap.cu", "svol_tpu/ops/hungarian.py:365"),
        ("attention_int8 (video self-attention L=1568; also query L=320)", "flash_int8",
         "svol_tpu_torch/csrc/flash_attention_int8.cu",
         "svol_tpu/ops/pallas/flash_attention.py:347"),
        ("flash_attention_bld (ViT self-attention, (B, L, D) = (256, 197, 768), H=12)",
         "flash_bld", "svol_tpu_torch/csrc/flash_attention.cu",
         "svol_tpu/ops/pallas/flash_attention.py:479"),
        ("layer_norm (ViT LayerNorm, 50,432 x 768 rows)", "layer_norm",
         "svol_tpu_torch/csrc/layer_norm.cu", "svol_tpu/ops/pallas/layer_norm.py:78"),
    ]
    runs = (launches, train_launches, int8_launches, vit_launches)
    log(f"launches: served bf16 run {launches}, train run {train_launches}, "
        f"served int8 run {int8_launches}, served ViT run {vit_launches}")
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=sum(run[key] for run in runs), **measured[key])
               for name, key, src, rep in entries]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
