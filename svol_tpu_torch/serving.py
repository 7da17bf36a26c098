"""Serving export: one directory a server can load without the training code.

    model.pt    the model's ``state_dict`` (``torch.save``), with the
                calibrated int8 scales where the model holds them
    meta.json   input signature, provenance and the model config

The JAX package bakes its weights into a StableHLO module; here the
artifact is the state dict plus the config needed to rebuild the model.
``load_exported`` returns the production predict path — uint8 pixels
normalized on the device, foreground softmax scores, clamped xyxy boxes —
over numpy batches. A ``quantize='int8'`` model serves the int8 path:
with the scales its ``state_dict`` carries (static, from
``ops.quant.calibrate_scales``), else with dynamic ones.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from svol_tpu_torch import resolve_device
from svol_tpu_torch.config import SvolConfig
from svol_tpu_torch.models.model import SketchLocalizationModel
from svol_tpu_torch.ops.quant import load_quant_scales, quant_scales
from svol_tpu_torch.train.steps import make_predict_fn

ARTIFACT_FILE = "model.pt"
META_FILE = "meta.json"


def _input_specs(config: SvolConfig, batch_size: int):
    T, S = config.data.num_frames, config.data.image_size
    n_sk = config.data.num_input_sketches
    return {
        "src_sketch": ((batch_size, n_sk, S, S, 3), "uint8"),
        "src_video": ((batch_size, T, S, S, 3), "uint8"),
        "src_sketch_mask": ((batch_size, n_sk), "float32"),
        "src_video_mask": ((batch_size, T), "float32"),
    }


def export_model(config: SvolConfig, state_dict: Dict[str, torch.Tensor],
                 out_dir: str, batch_size: int = 8) -> str:
    """Write ``state_dict`` and ``meta.json`` for a server of static batch
    ``batch_size`` that takes uint8 pixels. Returns ``out_dir``. A
    calibrated int8 model's ``state_dict`` holds its scales, and the
    artifact keeps them."""
    os.makedirs(out_dir, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               os.path.join(out_dir, ARTIFACT_FILE))
    meta = {
        "inputs": {k: {"shape": list(shape), "dtype": dt}
                   for k, (shape, dt) in
                   _input_specs(config, batch_size).items()},
        "outputs": ["scores (B, Q) f32", "boxes_xyxy (B, Q, 4) f32 in [0, 1]"],
        "batch_size": batch_size,
        "num_frames": config.data.num_frames,
        "num_queries_per_frame": config.model.num_queries_per_frame,
        "image_size": config.data.image_size,
        "pixel_dtype": "uint8",
        "platforms": ["cuda", "cpu"],
        "quantize": config.model.quantize,
        "torch_version": torch.__version__,
        "config": config.to_dict(),
    }
    with open(os.path.join(out_dir, META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


def load_exported(path: str, device=None,
                  ) -> Tuple[Callable[[Dict[str, Any]], Tuple[np.ndarray, np.ndarray]], Dict]:
    """(predict, meta) from an ``export_model`` directory. ``predict`` takes
    the batch dict of numpy arrays that ``meta["inputs"]`` describes and
    returns numpy ``(scores, boxes_xyxy)``. Runs on the card unless
    ``device`` says otherwise."""
    dev = resolve_device(device)
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    model = SketchLocalizationModel(SvolConfig.from_dict(meta["config"]))
    state = torch.load(os.path.join(path, ARTIFACT_FILE), map_location="cpu",
                       weights_only=True)
    load_quant_scales(model, quant_scales(state))
    model.load_state_dict(state, strict=True)
    model.eval().to(dev)
    predict_t = make_predict_fn(model)

    def predict(batch: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray]:
        inputs = {k: torch.from_numpy(np.require(batch[k], requirements="CW")).to(dev)
                  for k in meta["inputs"]}
        scores, boxes = predict_t(inputs)
        return scores.cpu().numpy(), boxes.cpu().numpy()

    return predict, meta
