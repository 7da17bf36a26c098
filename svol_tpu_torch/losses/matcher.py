"""Per-frame set matching on the card (port of svol_tpu/losses/matcher.py).

Targets are dense: ``boxes (B, T, K, 4)`` cxcywh with ``valid (B, T, K)``,
K = num_queries_per_frame. Each frame is one K x K LSAP over
    C = cost_bbox * L1 + cost_giou * (-GIoU) + cost_class * (-P_fg)
(foreground label 0), with invalid target columns padded on the real-cost
scale (ops/hungarian.masked_cost_matrix), and all B * T frames solve in one
batched call. Matching takes no gradient: callers pass detached outputs
and the functions run under ``torch.no_grad``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from svol_tpu_torch.ops.boxes import box_cxcywh_to_xyxy, generalized_box_iou
from svol_tpu_torch.ops.hungarian import hungarian, masked_cost_matrix


class MatchResult(NamedTuple):
    """``tgt_index[..., i]`` is the target column assigned to prediction
    row i of its frame; ``matched[..., i]`` says whether that column is a
    real (valid) target."""

    tgt_index: torch.Tensor  # (..., K) int64
    matched: torch.Tensor  # (..., K) bool


def _cost_matrix(pred_logits, pred_boxes, tgt_boxes, cost_class: float,
                 cost_bbox: float, cost_giou: float) -> torch.Tensor:
    # pred (..., K, 2) / (..., K, 4), targets (..., M, 4) -> (..., K, M)
    prob_fg = torch.softmax(pred_logits.float(), dim=-1)[..., 0]
    c_class = -prob_fg[..., :, None]
    c_bbox = (pred_boxes[..., :, None, :] - tgt_boxes[..., None, :, :]).abs().sum(-1)
    c_giou = -generalized_box_iou(box_cxcywh_to_xyxy(pred_boxes),
                                  box_cxcywh_to_xyxy(tgt_boxes))
    return (cost_bbox * c_bbox.float() + cost_giou * c_giou.float()
            + cost_class * c_class)


def _solve(C: torch.Tensor, tgt_valid: torch.Tensor) -> MatchResult:
    assign = hungarian(masked_cost_matrix(C, tgt_valid)).long()
    valid = tgt_valid.expand(assign.shape)
    return MatchResult(tgt_index=assign, matched=torch.gather(valid, -1, assign))


@torch.no_grad()
def match_per_frame(pred_logits, pred_boxes, tgt_boxes, tgt_valid,
                    cost_class: float = 2.0, cost_bbox: float = 5.0,
                    cost_giou: float = 1.0) -> MatchResult:
    """One K x K LSAP per frame: pred (B, T*K, .), targets (B, T, K, .).
    Returns (B, T, K) fields."""
    B, T, K, _ = tgt_boxes.shape
    _check_queries(pred_logits.shape[-2], T, K)
    logits = pred_logits.reshape(B, T, K, -1)
    boxes = pred_boxes.reshape(B, T, K, 4)
    C = _cost_matrix(logits, boxes, tgt_boxes, cost_class, cost_bbox, cost_giou)
    return _solve(C, tgt_valid)


@torch.no_grad()
def match_per_frame_stacked(all_logits, all_boxes, tgt_boxes, tgt_valid,
                            cost_class: float = 2.0, cost_bbox: float = 5.0,
                            cost_giou: float = 1.0) -> MatchResult:
    """Every decoder layer's per-frame LSAPs in one solver call: outputs
    stacked (Ly, B, T*K, .). Returns (Ly, B, T, K) fields, the same
    assignments as one match_per_frame per layer."""
    Ly = all_logits.shape[0]
    B, T, K, _ = tgt_boxes.shape
    _check_queries(all_logits.shape[-2], T, K)
    logits = all_logits.reshape(Ly, B, T, K, -1)
    boxes = all_boxes.reshape(Ly, B, T, K, 4)
    C = _cost_matrix(logits, boxes, tgt_boxes[None], cost_class, cost_bbox,
                     cost_giou)
    return _solve(C, tgt_valid[None])


def _check_queries(q: int, t: int, k: int) -> None:
    if q != t * k:
        raise ValueError(f"per-frame matching needs num_queries ({q}) = "
                         f"num_frames ({t}) * boxes per frame ({k})")
