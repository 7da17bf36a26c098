"""Train state, optimizer and LR schedule (port of svol_tpu/train/state.py).

Parameters and optimizer state stay float32; the model computes in its
compute dtype (``ModelConfig.compute_dtype``), casting parameters at each
use, as the JAX package's bf16 policy does.

* optimizer: ``torch.optim.AdamW(lr, weight_decay=wd)`` over every
  parameter, the update ``optax.adamw`` makes with no mask
  (p <- p - lr * (adam_update + wd * p));
* schedule: 'steplr', lr = base * 0.1 ** floor(step / lr_drop_step), the
  lr of step n being the schedule at n, as optax evaluates it;
* clipping: optax ``clip_by_global_norm`` when ``grad_clip_norm > 0``;
* EMA: an optional float32 shadow of the parameters (``ema_decay > 0``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from svol_tpu_torch import resolve_device
from svol_tpu_torch.config import SvolConfig
from svol_tpu_torch.models.model import init_weights


@dataclass
class TrainState:
    """What one train step reads and advances: the model (its parameters
    and BatchNorm running statistics), the optimizer and its schedule, the
    generator of the dropout masks, the step count and the optional EMA
    shadow of the parameters (``None`` when off)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    generator: torch.Generator
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None


def make_lr_schedule(config: SvolConfig) -> Callable[[int], float]:
    t = config.train
    if t.scheduler != "steplr":
        raise NotImplementedError(t.scheduler)
    base, drop = t.lr, max(1, t.lr_drop_step)
    return lambda step: base * 0.1 ** (step // drop)


def make_optimizer(config: SvolConfig, params) -> torch.optim.Optimizer:
    t = config.train
    if t.optimizer != "adamw":
        raise NotImplementedError(t.optimizer)
    return torch.optim.AdamW(params, lr=t.lr, weight_decay=t.wd)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32 (optax's
    ``global_norm``); a tensor on the card, no host synchronization."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: torch.Tensor) -> None:
    """optax ``clip_by_global_norm``, in place: gradients stay as they are
    when ``norm < max_norm``, else become g / norm * max_norm."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


def refuse_vit_training(config: SvolConfig) -> None:
    """The port's ViT kernels are forward only: its training slice (the
    (B, L, D) flash backward and the LayerNorm backward) is still to come."""
    if config.model.backbone == "vit":
        raise NotImplementedError(
            "training the ViT backbone is not ported yet (serving only)")


def create_train_state(config: SvolConfig, model: nn.Module,
                       generator: Optional[torch.Generator] = None,
                       device=None) -> TrainState:
    """Build the train state on ``device`` (the card unless told otherwise;
    without CUDA that raises). ``generator`` draws fresh weights
    (``init_weights``) before the move; ``None`` keeps the model's weights.
    Dropout masks come from a generator on the device seeded with
    ``config.train.seed``. The ViT backbone is not ported for training yet,
    and raises."""
    refuse_vit_training(config)
    dev = resolve_device(device)
    if generator is not None:
        init_weights(model, generator)
    model.to(dev).train()
    optimizer = make_optimizer(config, model.parameters())
    sched, base = make_lr_schedule(config), config.train.lr
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: sched(step) / base)
    ema = None
    if config.train.ema_decay > 0:
        # distinct buffers starting at the parameters
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(
        model=model, optimizer=optimizer, scheduler=scheduler,
        generator=torch.Generator(device=dev).manual_seed(config.train.seed),
        ema_params=ema)
