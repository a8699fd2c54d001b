"""Hungarian matching for the set-prediction loss (counterpart of
graph_detr4d_tpu/core/matching.py; reference: HungarianAssigner3D with
FocalLossCost weight 2.0 and BBox3DL1Cost weight 0.25).

Every function takes any leading batch axes, so one call matches every
decoder layer of every image: `match_targets` solves all of them in one
launch of K4 (ops/hungarian.py). GT is padded to max_gt with a validity
mask; padded rows cost a constant 1e4 (neutral to the real rows' optimum)
and their assignments are dropped.
"""

from typing import NamedTuple

import torch

from ..geometry.boxes import normalize_bbox
from ..ops import hungarian as lsa_ops

PADDED_ROW_COST = 1e4


def focal_cost(
    cls_logits: torch.Tensor,  # (..., Q, C)
    gt_labels: torch.Tensor,  # (..., G)
    alpha: float = 0.25,
    gamma: float = 2.0,
    eps: float = 1e-12,
) -> torch.Tensor:
    """mmdet FocalLossCost: (..., Q, G)."""
    p = torch.sigmoid(cls_logits.float())
    neg = -torch.log(1.0 - p + eps) * (1.0 - alpha) * p**gamma
    pos = -torch.log(p + eps) * alpha * (1.0 - p) ** gamma
    Q, G = cls_logits.shape[-2], gt_labels.shape[-1]
    idx = gt_labels.long()[..., None, :].expand(*gt_labels.shape[:-1], Q, G)
    return (pos - neg).gather(-1, idx)


def bbox_l1_cost(bbox_pred: torch.Tensor, gt_codes: torch.Tensor) -> torch.Tensor:
    """L1 cdist over the first 8 code dims: (..., Q, G)."""
    diff = bbox_pred[..., :, None, :8] - gt_codes[..., None, :, :8]
    return diff.abs().sum(-1)


def hungarian_match_cost(
    cls_logits: torch.Tensor,  # (..., Q, C)
    bbox_pred: torch.Tensor,  # (..., Q, 10)
    gt_bboxes: torch.Tensor,  # (..., G, 9) padded
    gt_labels: torch.Tensor,  # (..., G) padded
    gt_valid: torch.Tensor,  # (..., G) bool
    *,
    cls_weight: float = 2.0,
    reg_weight: float = 0.25,
) -> torch.Tensor:
    """(..., G, Q) cost matrices; padded GT rows get a constant."""
    gt_codes = normalize_bbox(gt_bboxes)
    gt_codes = torch.where(torch.isfinite(gt_codes), gt_codes, 0.0)
    cost = cls_weight * focal_cost(cls_logits, gt_labels)
    cost = cost + reg_weight * bbox_l1_cost(bbox_pred.float(), gt_codes)
    cost = cost.transpose(-1, -2)
    return torch.where(gt_valid.bool()[..., None], cost, PADDED_ROW_COST)


class MatchTargets(NamedTuple):
    labels: torch.Tensor  # (..., Q) int64, num_classes = background
    label_weights: torch.Tensor  # (..., Q)
    bbox_targets: torch.Tensor  # (..., Q, 9)
    bbox_weights: torch.Tensor  # (..., Q)
    num_pos: torch.Tensor  # (...) float


@torch.no_grad()
def match_targets(
    cls_logits: torch.Tensor,  # (..., Q, C)
    bbox_pred: torch.Tensor,  # (..., Q, 10)
    gt_bboxes: torch.Tensor,  # (..., G, 9)
    gt_labels: torch.Tensor,  # (..., G)
    gt_valid: torch.Tensor,  # (..., G)
    *,
    num_classes: int = 10,
    cls_weight: float = 2.0,
    reg_weight: float = 0.25,
) -> MatchTargets:
    """Match every problem (all leading axes) and build dense per-query
    targets (detr3d_head_pe.py:674-729 semantics with static shapes)."""
    lead = cls_logits.shape[:-2]
    Q = cls_logits.shape[-2]
    G, D = gt_bboxes.shape[-2:]
    cost = hungarian_match_cost(
        cls_logits, bbox_pred, gt_bboxes, gt_labels, gt_valid,
        cls_weight=cls_weight, reg_weight=reg_weight,
    ).reshape(-1, G, Q)
    valid = gt_valid.bool().reshape(-1, G)
    # rows permuted valid-first (stable: validity need not be a prefix),
    # solved up to num_valid, then un-permuted
    order = torch.argsort((~valid).to(torch.int32), dim=-1, stable=True)
    q_sorted = lsa_ops.hungarian_assignment(
        cost.gather(1, order[..., None].expand(-1, -1, Q)), valid.sum(-1)
    ).long()
    q_for_gt = torch.empty_like(q_sorted).scatter_(1, order, q_sorted)
    # unsolved rows (-1) go to column Q, a trash column sliced off below:
    # JAX drops an out-of-bounds scatter, PyTorch raises on one
    q_for_gt = torch.where(q_for_gt < 0, Q, q_for_gt)

    P = valid.shape[0]
    valid_f = valid.float()
    labels = torch.full((P, Q + 1), num_classes, dtype=torch.int64,
                        device=cost.device)
    labels.scatter_(1, q_for_gt, torch.where(
        valid, gt_labels.reshape(P, G).long(), num_classes))
    bbox_targets = torch.zeros(P, Q + 1, D, device=cost.device)
    bbox_targets.scatter_(
        1, q_for_gt[..., None].expand(-1, -1, D),
        gt_bboxes.reshape(P, G, D).float() * valid_f[..., None])
    bbox_weights = torch.zeros(P, Q + 1, device=cost.device)
    bbox_weights.scatter_(1, q_for_gt, valid_f)
    return MatchTargets(
        labels=labels[:, :Q].reshape(*lead, Q),
        label_weights=torch.ones(*lead, Q, device=cost.device),
        bbox_targets=bbox_targets[:, :Q].reshape(*lead, Q, D),
        bbox_weights=bbox_weights[:, :Q].reshape(*lead, Q),
        num_pos=valid_f.sum(-1).reshape(lead),
    )
