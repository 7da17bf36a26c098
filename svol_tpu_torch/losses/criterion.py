"""Set criterion: CE + L1 + GIoU over Hungarian-matched pairs (port of
svol_tpu/losses/criterion.py), with the reference's normalization:

* loss_label: per-element weighted NLL (foreground weight 1, background
  eos_coef) averaged over all B * Q logits, i.e. divided by the count;
* loss_bbox: L1 averaged over num_matched * 4 coordinates;
* loss_giou: (1 - GIoU) averaged over matched pairs;
* class_error: 100 - top-1 accuracy of the matched logits (logging);
* cardinality_error: |#foreground predicted - #targets| averaged over the
  batch (logging).

Aux layers are matched and scored the same way, their keys suffixed
``_i``. Everything stays on the card: no host synchronization.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from svol_tpu_torch.config import SvolConfig
from svol_tpu_torch.losses.matcher import (
    MatchResult,
    match_per_frame,
    match_per_frame_stacked,
)
from svol_tpu_torch.ops.boxes import box_cxcywh_to_xyxy, generalized_box_iou

FOREGROUND = 0
BACKGROUND = 1


def _losses_for_layer(pred_logits, pred_boxes, tgt_boxes, tgt_valid,
                      match: MatchResult, eos_coef: float) -> Dict[str, torch.Tensor]:
    B, Q, _ = pred_logits.shape
    matched = match.matched.reshape(B, Q)

    logp = F.log_softmax(pred_logits.float(), dim=-1)
    nll = torch.where(matched, -logp[..., FOREGROUND], -logp[..., BACKGROUND])
    weight = torch.where(matched, 1.0, eos_coef)
    loss_label = (weight * nll).mean()

    pred_cls = pred_logits.argmax(dim=-1)
    n_matched = matched.sum().clamp(min=1)
    acc = (matched & (pred_cls == FOREGROUND)).sum() / n_matched
    class_error = 100.0 * (1.0 - acc)

    # match indices are per-frame columns
    sel = torch.gather(tgt_boxes, 2,
                       match.tgt_index[..., None].expand(-1, -1, -1, 4))
    sel = sel.reshape(B, Q, 4).float()
    pred = pred_boxes.float()
    m = matched.float()

    l1 = (pred - sel).abs().sum(-1)
    denom = m.sum().clamp(min=1.0)
    loss_bbox = (l1 * m).sum() / (denom * 4.0)

    giou = generalized_box_iou(box_cxcywh_to_xyxy(pred)[..., None, :],
                               box_cxcywh_to_xyxy(sel)[..., None, :])[..., 0, 0]
    loss_giou = ((1.0 - giou) * m).sum() / denom

    card_pred = (pred_cls != pred_logits.shape[-1] - 1).sum(-1).float()
    n_tgt = tgt_valid.reshape(B, -1).sum(-1).float()
    cardinality_error = (card_pred - n_tgt).abs().mean()
    return {
        "loss_label": loss_label,
        "loss_bbox": loss_bbox,
        "loss_giou": loss_giou,
        "class_error": class_error,
        "cardinality_error": cardinality_error,
    }


class SetCriterion:
    """Callable criterion bound to a config (build_loss, loss.py:192-213)."""

    def __init__(self, config: SvolConfig):
        l = config.loss
        self.cost_class = float(l.set_cost_class)
        self.cost_bbox = float(l.set_cost_bbox)
        self.cost_giou = float(l.set_cost_giou)
        self.eos_coef = float(l.eos_coef)
        self.aux_loss = bool(l.aux_loss)
        self.merged_matcher = bool(l.merged_matcher)
        self.weight_dict: Dict[str, float] = {
            "loss_bbox": self.cost_bbox,
            "loss_giou": self.cost_giou,
            "loss_label": self.cost_class,
        }
        if self.aux_loss:
            for i in range(config.model.num_layers - 1):
                for k in ("loss_bbox", "loss_giou", "loss_label"):
                    self.weight_dict[f"{k}_{i}"] = self.weight_dict[k]

    def weighted_log_view(self, losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The reference's logging convention: each weighted component is
        logged as value * weight; other keys as they are."""
        return {k: (v * self.weight_dict[k] if k in self.weight_dict else v)
                for k, v in losses.items()}

    def _costs(self):
        return dict(cost_class=self.cost_class, cost_bbox=self.cost_bbox,
                    cost_giou=self.cost_giou)

    def __call__(self, outputs: Dict[str, torch.Tensor],
                 targets: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        tgt_boxes, tgt_valid = targets["boxes"], targets["box_valid"]
        logits, boxes = outputs["pred_logits"], outputs["pred_boxes"]
        has_aux = self.aux_loss and "aux_logits" in outputs
        layers = [(logits, boxes)]
        if has_aux:
            layers += list(zip(outputs["aux_logits"].unbind(0),
                               outputs["aux_boxes"].unbind(0)))

        if self.merged_matcher and has_aux:
            # one (layers * B * T)-wide solve for final + all aux layers
            stacked = match_per_frame_stacked(
                torch.stack([lg.detach() for lg, _ in layers]),
                torch.stack([bx.detach() for _, bx in layers]),
                tgt_boxes, tgt_valid, **self._costs())
            matches = [MatchResult(t, m) for t, m in
                       zip(stacked.tgt_index.unbind(0), stacked.matched.unbind(0))]
        else:
            matches = [match_per_frame(lg.detach(), bx.detach(), tgt_boxes,
                                       tgt_valid, **self._costs())
                       for lg, bx in layers]

        losses: Dict[str, torch.Tensor] = {}
        for n, ((lg, bx), match) in enumerate(zip(layers, matches)):
            out = _losses_for_layer(lg, bx, tgt_boxes, tgt_valid, match,
                                    self.eos_coef)
            suffix = "" if n == 0 else f"_{n - 1}"
            losses.update({k + suffix: v for k, v in out.items()})
        losses["loss_overall"] = sum(losses[k] * w for k, w in
                                     self.weight_dict.items() if k in losses)
        return losses


def build_criterion(config: SvolConfig) -> SetCriterion:
    return SetCriterion(config)
