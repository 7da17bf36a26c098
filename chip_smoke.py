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
  6. (--profile) kernel time by name over one batch-8 predict.
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


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def serve(torch, cfg_mod, model_mod, serving, serve_cli, flash_mod, gated_mod,
          B: int, n_requests: int, seed: int):
    """Phase 5. Returns {name: launches} from the served run."""
    import numpy as np

    cfg = cfg_mod.SvolConfig(model=cfg_mod.ModelConfig(use_pallas_attention=True))
    T, S, Q = cfg.data.num_frames, cfg.data.image_size, cfg.model.num_queries
    model = model_mod.SketchLocalizationModel(cfg)
    model_mod.init_weights(model, torch.Generator().manual_seed(seed))
    tmp = tempfile.TemporaryDirectory(prefix="svol_smoke_")
    try:
        export_dir = serving.export_model(cfg, model.state_dict(),
                                          os.path.join(tmp.name, "export"), batch_size=B)
        del model
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
            flash_mod.flash_attention.launches = 0
            flash_mod.flash_attention.launches_short = 0
            gated_mod.gated_attention.launches = 0
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
            launches = {
                "flash_long": (flash_mod.flash_attention.launches
                               - flash_mod.flash_attention.launches_short),
                "flash_short": flash_mod.flash_attention.launches_short,
                "gated": gated_mod.gated_attention.launches,
            }
            if any(t.is_alive() for t in threads) or errors:
                raise RuntimeError(f"clients failed: {errors}")
            snap = stats.snapshot()
        finally:
            server.shutdown()
            server.server_close()
            batcher.stop()
            thread.join(timeout=30)

        batches = snap["total_batches"]
        log(f"served {n_requests} requests in {batches} batches "
            f"(occupancy {snap['batch_occupancy']}), launches {launches}")
        want = {"flash_long": 2 * batches, "flash_short": 2 * batches, "gated": 2 * batches}
        if launches != want or batches == 0:
            raise AssertionError(f"launch counts {launches} != {want}")

        predict, _ = serving.load_exported(export_dir, device="cuda")
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
        log(f"every response matches a direct predict within {SERVE_ATOL}; "
            f"clips differ from each other by up to {spread:.3e}")

        lat = np.asarray([r[1]["latency_ms"] for r in responses])
        full = {k: np.stack([clips[i % n_requests][k] for i in range(B)])
                for k in ("src_video", "src_sketch")}
        full["src_video_mask"] = np.ones((B, T), np.float32)
        full["src_sketch_mask"] = np.ones((B, 1), np.float32)
        predict(full)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            predict(full)
        torch.cuda.synchronize()
        batch_s = (time.perf_counter() - t1) / reps
        log(f"serve: p50 {np.percentile(lat, 50):.3f} ms, p90 {np.percentile(lat, 90):.3f} ms, "
            f"{n_requests * T / wall:.1f} frames/s over {wall:.3f} s with {CLIENTS} "
            f"clients, batch occupancy {snap['batch_occupancy']}; "
            f"direct batch-{B} predict {batch_s * 1e3:.3f} ms = {B * T / batch_s:.1f} frames/s")
        log(f"serve measured on {gpu_line()}")
        return launches, predict, full
    finally:
        tmp.cleanup()


def profile(torch, predict, full) -> None:
    from torch.profiler import ProfilerActivity, profile as prof

    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        predict(full)
        torch.cuda.synchronize()
    log(p.key_averages().table(sort_by="cuda_time_total", row_limit=25))


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
    from svol_tpu_torch.models import model as model_mod
    from svol_tpu_torch.ops.kernels import build
    from svol_tpu_torch.ops.kernels import flash_attention as flash_mod
    from svol_tpu_torch.ops.kernels import gated_attention as gated_mod
    from svol_tpu_torch.train import steps

    t_start = time.perf_counter()
    card = gpu_line()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}; {torch.cuda.get_device_name(0)}")
    log(f"nvidia-smi: {card}")

    secs = build.build()
    log(f"build: {secs:.1f} s")
    for name, out in sorted(build.build_log.items()):
        log(f"--- nvcc {name}.cu ---\n{out.strip()}")

    B = 8
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        measured = check_kernels(torch, F, flash_mod, gated_mod, B, args.seed)
        check_end_to_end(torch, cfg_mod, model_mod, steps, args.seed)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    launches, predict, full = serve(torch, cfg_mod, model_mod, serving, serve_cli,
                                    flash_mod, gated_mod, B, args.requests, args.seed)
    if args.profile:
        profile(torch, predict, full)

    entries = [
        ("flash_attention (video self-attention, L=1568)", "flash_long",
         "svol_tpu_torch/csrc/flash_attention.cu", "svol_tpu/ops/pallas/flash_attention.py:167"),
        ("flash_attention (query self-attention, L=320)", "flash_short",
         "svol_tpu_torch/csrc/flash_attention.cu", "svol_tpu/ops/pallas/flash_attention.py:153"),
        ("gated_attention", "gated",
         "svol_tpu_torch/csrc/gated_attention.cu", "svol_tpu/ops/pallas/gated_attention.py:112"),
    ]
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[key], **measured[key])
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
