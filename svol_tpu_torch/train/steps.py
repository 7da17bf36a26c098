"""Train and predict steps (port of svol_tpu/train/steps.py).

The train step stays on the card from the batch to the updated state:
forward, per-frame Hungarian matching (the LSAP kernel), loss, backward and
the AdamW update never synchronize with the host: no ``.item()``, no
data-dependent Python branch, no ``nonzero``. Its metrics come back as
tensors on the card.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from svol_tpu_torch.config import SvolConfig
from svol_tpu_torch.losses.criterion import SetCriterion
from svol_tpu_torch.ops.boxes import box_cxcywh_to_xyxy
from svol_tpu_torch.train.state import (
    TrainState,
    clip_by_global_norm,
    global_norm,
    refuse_vit_training,
)


def make_train_step(config: SvolConfig, criterion: SetCriterion) -> Callable:
    """train_step(state, batch) -> (state, metrics), advancing ``state`` in
    place: ``_train_step_body`` of the JAX package. ``batch`` holds the
    model inputs plus ``boxes`` (B, T, K, 4) and ``box_valid`` (B, T, K) on
    the model's device; ``metrics`` is the weighted log view of every loss
    plus ``grad_norm``, the global norm of the unclipped gradients. The ViT
    backbone is not ported for training yet, and raises."""
    refuse_vit_training(config)
    clip = config.train.grad_clip_norm
    ema_decay = config.train.ema_decay

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model = state.model
        model.train()
        outputs = model(
            src_sketch=batch["src_sketch"], src_video=batch["src_video"],
            src_sketch_mask=batch["src_sketch_mask"],
            src_video_mask=batch["src_video_mask"],
            generator=state.generator)
        losses = criterion(outputs, {"boxes": batch["boxes"],
                                     "box_valid": batch["box_valid"]})
        state.optimizer.zero_grad(set_to_none=True)
        losses["loss_overall"].backward()
        grads = [p.grad for p in model.parameters()]
        grad_norm = global_norm(grads)
        if clip > 0:
            clip_by_global_norm(grads, clip, grad_norm)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        if state.ema_params is not None and ema_decay > 0:
            _update_ema(state, ema_decay)
        metrics = criterion.weighted_log_view(
            {k: v.detach() for k, v in losses.items()})
        metrics["grad_norm"] = grad_norm.detach()
        return state, metrics

    return train_step


@torch.no_grad()
def _update_ema(state: TrainState, decay: float) -> None:
    """ema <- decay * ema + (1 - decay) * params."""
    for name, p in state.model.named_parameters():
        e = state.ema_params[name]
        e.copy_(e * decay + p.to(e.dtype) * (1.0 - decay))


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
