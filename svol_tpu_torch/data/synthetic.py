"""Training batches made from a seed, for driving the train step without a
dataset: the port's copy of the JAX package's ``_sample_batch`` (uint8
pixels, targets on), with target boxes that vary with the seed so that
matching is not trivial."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from svol_tpu_torch.config import SvolConfig

MAX_TARGETS = 3  # boxes per frame at most, fewer where K is smaller


def sample_train_batch(config: SvolConfig, batch_size: int,
                       seed: int = 0) -> Dict[str, np.ndarray]:
    """numpy batch: uint8 ``src_sketch`` (B, 1, S, S, 3) and ``src_video``
    (B, T, S, S, 3), all-valid masks, and per-frame targets: 0 to
    ``MAX_TARGETS`` boxes (cxcywh, inside the frame) in the first slots of
    ``boxes`` (B, T, K, 4), flagged by ``box_valid`` (B, T, K); the other
    slots hold zeros."""
    T, S = config.data.num_frames, config.data.image_size
    K = config.data.max_boxes_per_frame
    rng = np.random.default_rng(seed)
    n_valid = rng.integers(0, min(MAX_TARGETS, K) + 1, (batch_size, T))
    valid = np.arange(K) < n_valid[..., None]
    wh = rng.uniform(0.05, 0.4, (batch_size, T, K, 2))
    c = rng.uniform(wh / 2, 1.0 - wh / 2)
    boxes = np.where(valid[..., None], np.concatenate([c, wh], -1), 0.0)
    return {
        "src_sketch": rng.integers(0, 256, (batch_size, 1, S, S, 3), np.uint8),
        "src_video": rng.integers(0, 256, (batch_size, T, S, S, 3), np.uint8),
        "src_sketch_mask": np.ones((batch_size, 1), np.float32),
        "src_video_mask": np.ones((batch_size, T), np.float32),
        "boxes": boxes.astype(np.float32),
        "box_valid": valid,
    }


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
