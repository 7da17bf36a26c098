"""Predict step (port of ``make_predict_fn`` in svol_tpu/train/steps.py)."""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from svol_tpu_torch.ops.boxes import box_cxcywh_to_xyxy


def make_predict_fn(model: torch.nn.Module) -> Callable:
    """predict(batch) -> (scores (B, Q), boxes_xyxy (B, Q, 4)), both f32:
    the foreground (index 0) softmax probability and the boxes in corner
    format clamped to [0, 1]. ``batch`` holds src_sketch, src_video,
    src_sketch_mask and src_video_mask tensors on the model's device."""

    @torch.inference_mode()
    def predict(batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        outputs = model(
            src_sketch=batch["src_sketch"],
            src_video=batch["src_video"],
            src_sketch_mask=batch["src_sketch_mask"],
            src_video_mask=batch["src_video_mask"],
        )
        prob = torch.softmax(outputs["pred_logits"].float(), dim=-1)
        boxes = box_cxcywh_to_xyxy(outputs["pred_boxes"].float()).clamp(0.0, 1.0)
        return prob[..., 0], boxes

    return predict
