"""The port's serving export and batching server, on the CPU.

``start_server(..., device="cpu")`` over a tiny ``export_model`` directory
on an ephemeral port: concurrent POSTs share dispatches, each response
equals a direct predict of the same clip, and its ``frames`` equal what the
JAX server's ``frames_view`` makes of the same arrays.
"""
import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from svol_tpu.cli.serve import frames_view as jax_frames_view
from svol_tpu_torch import serving
from svol_tpu_torch.cli.serve import parse_request, start_server
from svol_tpu_torch.config import DataConfig, ModelConfig, SvolConfig
from svol_tpu_torch.models.model import SketchLocalizationModel, init_weights
from torch_port_reference_cache import prefetch_costly_references  # noqa: F401
from torch_port_threads import one_torch_thread  # noqa: F401

T, K, IMG, BS = 2, 3, 64, 4


def tiny_cfg():
    return SvolConfig(
        data=DataConfig(num_frames=T, image_size=IMG),
        model=ModelConfig(hidden_dim=32, nheads=4, num_layers=2,
                          num_queries=T * K, num_queries_per_frame=K,
                          cmt_dim_feedforward=64, compute_dtype="float32",
                          use_pallas_attention=True))


def _clip(seed):
    rng = np.random.default_rng(seed)
    return {
        "src_video": rng.integers(0, 256, (T, IMG, IMG, 3), dtype=np.uint8),
        "src_sketch": rng.integers(0, 256, (1, IMG, IMG, 3), dtype=np.uint8),
    }


def _post(port, clip):
    buf = io.BytesIO()
    np.savez(buf, **clip)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, json.loads(r.read())


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    model = SketchLocalizationModel(tiny_cfg())
    init_weights(model, torch.Generator().manual_seed(0))
    return serving.export_model(tiny_cfg(), model.state_dict(),
                                str(tmp_path_factory.mktemp("export")),
                                batch_size=BS)


def test_entry_points_require_the_card_unless_told(export_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.load_exported(export_dir)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        start_server(export_dir, port=0)


def test_server_answers_concurrent_requests_like_direct_predict(export_dir):
    server, batcher, stats, port = start_server(
        export_dir, port=0, batch_timeout_ms=300.0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        clips = [_clip(seed) for seed in range(3)]
        results = [None] * 3

        def client(i):
            results[i] = _post(port, clips[i])

        clients = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
        assert not any(c.is_alive() for c in clients)

        predict, meta = serving.load_exported(export_dir, device="cpu")
        for clip, (status, resp) in zip(clips, results):
            assert status == 200
            batch = {
                "src_video": np.broadcast_to(clip["src_video"], (BS, T, IMG, IMG, 3)),
                "src_sketch": np.broadcast_to(clip["src_sketch"], (BS, 1, IMG, IMG, 3)),
                "src_video_mask": np.ones((BS, T), np.float32),
                "src_sketch_mask": np.ones((BS, 1), np.float32),
            }
            scores, boxes = predict(batch)
            # same model, same batch size, f32 on the CPU
            np.testing.assert_allclose(resp["scores"], scores[0], atol=1e-5, rtol=0)
            np.testing.assert_allclose(resp["boxes_xyxy"], boxes[0], atol=1e-5, rtol=0)
            assert resp["frames"] == jax_frames_view(
                np.asarray(resp["scores"]), np.asarray(resp["boxes_xyxy"]), T)
            assert len(resp["frames"]) == T and all(len(f) == K for f in resp["frames"])

        _, health = _get(port, "/healthz")
        assert health["batch_size"] == BS and health["num_frames"] == T
        _, metrics = _get(port, "/metrics")
        assert metrics["total_requests"] == 3
        assert sum(int(n) * c for n, c in metrics["batch_occupancy"].items()) == 3
        assert meta["config"]["model"]["use_pallas_attention"] is True
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()


def test_parse_request_takes_uint8_pixels_and_refuses_other_dtypes(export_dir):
    _, meta = serving.load_exported(export_dir, device="cpu")
    assert meta["pixel_dtype"] == "uint8"
    in_specs = {k: (tuple(v["shape"][1:]), np.dtype(v["dtype"]))
                for k, v in meta["inputs"].items()}
    assert in_specs["src_video"] == ((T, IMG, IMG, 3), np.uint8)

    clip = _clip(7)
    buf = io.BytesIO()
    np.savez(buf, **clip)
    inputs = parse_request(buf.getvalue(), in_specs)
    np.testing.assert_array_equal(inputs["src_video"], clip["src_video"])
    np.testing.assert_array_equal(inputs["src_video_mask"], np.ones(T, np.float32))

    buf = io.BytesIO()
    np.savez(buf, src_video=clip["src_video"].astype(np.float32) / 255.0,
             src_sketch=clip["src_sketch"])
    with pytest.raises(ValueError, match="dtype"):
        parse_request(buf.getvalue(), in_specs)
