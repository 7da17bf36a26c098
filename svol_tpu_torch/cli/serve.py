"""Batching inference server over the port's serving export.

Port of svol_tpu/cli/serve.py: requests arrive one clip at a time and share
device dispatches through a dynamic batcher:

    request (1 clip) -> queue -> batcher coalesces up to the artifact's
    static batch B within --batch_timeout_ms -> ONE forward on the card ->
    per-request responses.

Partial batches pad to exactly B rows by repeating row 0 and pad rows are
dropped on the way out. A single consumer thread owns the device: HTTP
handler threads only parse, enqueue and wait, so concurrent clients never
race dispatches.

Protocol (stdlib-only, the same as the JAX server's):

    POST /predict   body: ``.npz`` bytes with ``src_video`` (T, S, S, 3)
                    and ``src_sketch`` ((n_sk,) S, S, 3), uint8;
                    optional ``src_video_mask`` (T,) / ``src_sketch_mask``
                    (n_sk,) float32 (default all-ones).
                    -> JSON {"scores", "boxes_xyxy", "frames",
                    "latency_ms"} where "frames" is the per-frame
                    score-sorted [x1, y1, x2, y2, score] rows of the
                    reference's JSONL ``pred_boxes`` schema (4-decimal
                    rounding included).
    GET /healthz    artifact meta + uptime.
    GET /metrics    latency percentiles (p50/p90/p99), request/batch
                    counts, batch-occupancy histogram, queue depth.

Run:  python -m svol_tpu_torch.cli.serve --from_export <dir> [--port 8100]
(on the card; ``start_server(..., device="cpu")`` serves from the CPU).
"""
from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time
from collections import defaultdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from svol_tpu_torch.serving import load_exported


def _round4(x: float) -> float:
    return float(f"{x:.4f}")


class ServerStats:
    """Thread-safe latency/throughput accounting over a sliding window."""

    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self._window = window
        self._latencies_ms: List[float] = []
        self.total_requests = 0
        self.total_batches = 0
        self.batch_occupancy: Dict[int, int] = defaultdict(int)
        self.started = time.time()

    def record_batch(self, n_real: int) -> None:
        with self._lock:
            self.total_batches += 1
            self.batch_occupancy[n_real] += 1

    def record_latency(self, ms: float) -> None:
        with self._lock:
            self.total_requests += 1
            self._latencies_ms.append(ms)
            if len(self._latencies_ms) > self._window:
                del self._latencies_ms[: -self._window]

    def snapshot(self, queue_depth: int = 0) -> Dict[str, Any]:
        with self._lock:
            lats = np.asarray(self._latencies_ms, dtype=np.float64)
            uptime = time.time() - self.started
            out = {
                "total_requests": self.total_requests,
                "total_batches": self.total_batches,
                "batch_occupancy": dict(sorted(self.batch_occupancy.items())),
                "queue_depth": queue_depth,
                "uptime_s": round(uptime, 3),
                "requests_per_s": round(self.total_requests / max(uptime, 1e-9), 3),
            }
            if lats.size:
                out.update({
                    "latency_ms_p50": round(float(np.percentile(lats, 50)), 3),
                    "latency_ms_p90": round(float(np.percentile(lats, 90)), 3),
                    "latency_ms_p99": round(float(np.percentile(lats, 99)), 3),
                    "latency_ms_mean": round(float(lats.mean()), 3),
                })
            return out


class _Pending:
    """One enqueued request; the handler thread waits on ``event``."""

    __slots__ = ("inputs", "event", "scores", "boxes", "error")

    def __init__(self, inputs: Dict[str, np.ndarray]):
        self.inputs = inputs
        self.event = threading.Event()
        self.scores: Optional[np.ndarray] = None
        self.boxes: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


class DynamicBatcher:
    """Single consumer thread coalescing requests into fixed-B dispatches.

    The first request of a batch opens a ``timeout_ms`` window; whatever
    arrives inside it (up to ``batch_size``) rides the same device
    dispatch. Partial batches pad by repeating row 0 (the artifact's
    static batch size), and pad outputs are discarded.
    """

    def __init__(self, predict: Callable, batch_size: int,
                 timeout_ms: float, stats: ServerStats):
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._predict = predict
        self._batch_size = int(batch_size)
        self._timeout_s = float(timeout_ms) / 1000.0
        self._stats = stats
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="svol-batcher", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self, join_timeout: float = 10.0) -> None:
        self._stop.set()
        self._thread.join(timeout=join_timeout)
        # fail any requests still queued so handler threads don't hang
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                break
            p.error = RuntimeError("server shutting down")
            p.event.set()

    def queue_depth(self) -> int:
        return self._q.qsize()

    def submit(self, inputs: Dict[str, np.ndarray]) -> _Pending:
        pending = _Pending(inputs)
        self._q.put(pending)
        return pending

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self._timeout_s
            while len(batch) < self._batch_size:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            self._dispatch(batch)

    def _dispatch(self, batch: List[_Pending]) -> None:
        n = len(batch)
        try:
            stacked = {}
            for key in batch[0].inputs:
                rows = [p.inputs[key] for p in batch]
                if n < self._batch_size:
                    rows = rows + [rows[0]] * (self._batch_size - n)
                stacked[key] = np.stack(rows)
            scores, boxes = self._predict(stacked)
            scores = np.asarray(scores)
            boxes = np.asarray(boxes)
        except BaseException as e:  # surface device errors to every caller
            for p in batch:
                p.error = e
                p.event.set()
            return
        self._stats.record_batch(n)
        for i, p in enumerate(batch):
            p.scores = scores[i]
            p.boxes = boxes[i]
            p.event.set()


def parse_request(body: bytes, in_specs: Dict[str, Tuple[Tuple[int, ...], np.dtype]],
                  ) -> Dict[str, np.ndarray]:
    """Decode and validate one ``.npz`` request against the artifact
    signature (per-example shapes — the batch dim belongs to the server).

    Missing masks default to all-ones. Any mismatch of shape or dtype
    raises ValueError -> HTTP 400 (no conversion is attempted).
    """
    try:
        npz = np.load(io.BytesIO(body), allow_pickle=False)
    except Exception as e:
        raise ValueError(f"body is not a readable .npz archive: {e}") from e
    inputs: Dict[str, np.ndarray] = {}
    for key, (shape, want_dt) in in_specs.items():
        if key in npz.files:
            arr = np.asarray(npz[key])
        elif key.endswith("_mask"):
            arr = np.ones(shape, np.float32)
        else:
            raise ValueError(f"missing required array '{key}' "
                             f"(expected shape {shape}, dtype {want_dt})")
        if key == "src_sketch" and arr.ndim == len(shape) - 1 and shape[0] == 1:
            arr = arr[None]  # allow (S, S, 3) for single-sketch artifacts
        if tuple(arr.shape) != shape:
            raise ValueError(f"'{key}': got shape {tuple(arr.shape)}, "
                             f"artifact expects {shape}")
        if arr.dtype != want_dt:
            raise ValueError(f"'{key}': got dtype {arr.dtype}, artifact "
                             f"expects {want_dt}")
        inputs[key] = arr
    return inputs


def frames_view(scores: np.ndarray, boxes: np.ndarray,
                num_frames: int) -> List[List[List[float]]]:
    """Chunk the Q = T*K queries per-frame and sort by score descending —
    the reference's JSONL ``pred_boxes`` rows (test.py:153-170)."""
    Q = scores.shape[0]
    K = Q // num_frames
    out = []
    for t in range(num_frames):
        s = scores[t * K:(t + 1) * K]
        bx = boxes[t * K:(t + 1) * K]
        order = np.argsort(-s, kind="stable")
        out.append([[_round4(v) for v in (*bx[i], s[i])] for i in order])
    return out


def make_handler(batcher: DynamicBatcher, meta: Dict[str, Any],
                 stats: ServerStats, request_timeout_s: float):
    in_specs = {
        k: (tuple(v["shape"][1:]), np.dtype(v["dtype"]))
        for k, v in meta["inputs"].items()
    }
    num_frames = int(meta["num_frames"])
    health = {
        "status": "ok",
        "batch_size": meta["batch_size"],
        "num_frames": meta["num_frames"],
        "image_size": meta["image_size"],
        "num_queries_per_frame": meta["num_queries_per_frame"],
        "pixel_dtype": meta["pixel_dtype"],
        "platforms": meta["platforms"],
        "quantize": meta.get("quantize", "none"),
    }

    class Handler(BaseHTTPRequestHandler):
        # stdlib default logs every request to stderr; keep the server quiet
        def log_message(self, fmt, *args):  # noqa: N802
            pass

        def _json(self, code: int, obj: Dict[str, Any]) -> None:
            blob = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._json(200, health)
            elif self.path == "/metrics":
                self._json(200, stats.snapshot(batcher.queue_depth()))
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/predict":
                return self._json(404, {"error": f"unknown path {self.path}"})
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            try:
                inputs = parse_request(body, in_specs)
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            t0 = time.perf_counter()
            pending = batcher.submit(inputs)
            if not pending.event.wait(request_timeout_s):
                return self._json(
                    504, {"error": f"timed out after {request_timeout_s}s"})
            if pending.error is not None:
                return self._json(500, {"error": repr(pending.error)})
            latency_ms = (time.perf_counter() - t0) * 1000.0
            stats.record_latency(latency_ms)
            self._json(200, {
                "scores": [float(v) for v in pending.scores],
                "boxes_xyxy": [[float(v) for v in row] for row in pending.boxes],
                "frames": frames_view(pending.scores, pending.boxes, num_frames),
                "latency_ms": round(latency_ms, 3),
            })

    return Handler


def start_server(
    export_dir: str,
    host: str = "127.0.0.1",
    port: int = 0,
    batch_timeout_ms: float = 5.0,
    request_timeout_s: float = 120.0,
    warmup: bool = True,
    device=None,
) -> Tuple[ThreadingHTTPServer, DynamicBatcher, ServerStats, int]:
    """Load the artifact onto ``device`` (the card unless told otherwise),
    warm it up, and bind the server (no serve loop started — callers run
    ``serve_forever`` themselves; tests run it on a thread). Returns
    (server, batcher, stats, bound_port)."""
    predict, meta = load_exported(export_dir, device)
    if warmup:
        # one dispatch on zeros so the first real request never pays the
        # kernel build, library handle setup or allocator growth
        zeros = {k: np.zeros(v["shape"], np.dtype(v["dtype"]))
                 for k, v in meta["inputs"].items()}
        predict(zeros)

    stats = ServerStats()
    batcher = DynamicBatcher(predict, meta["batch_size"], batch_timeout_ms, stats)
    batcher.start()
    handler = make_handler(batcher, meta, stats, request_timeout_s)
    server = ThreadingHTTPServer((host, port), handler)
    return server, batcher, stats, server.server_address[1]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--from_export", required=True,
                    help="directory written by svol_tpu_torch.serving."
                         "export_model (model.pt + meta.json)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8100,
                    help="0 = ephemeral (bound port is printed)")
    ap.add_argument("--batch_timeout_ms", type=float, default=5.0,
                    help="how long the first request of a batch waits for "
                         "company before dispatching")
    ap.add_argument("--request_timeout_s", type=float, default=120.0)
    ap.add_argument("--no_warmup", action="store_true")
    args = ap.parse_args(argv)

    server, batcher, _stats, port = start_server(
        args.from_export, args.host, args.port,
        batch_timeout_ms=args.batch_timeout_ms,
        request_timeout_s=args.request_timeout_s,
        warmup=not args.no_warmup,
    )
    print(f"svol_tpu_torch serving on http://{args.host}:{port} "
          f"(artifact: {args.from_export})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()


if __name__ == "__main__":
    main()
