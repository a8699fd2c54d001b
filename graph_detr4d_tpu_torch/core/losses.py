"""NMS-free set-prediction loss over all decoder layers (counterpart of
graph_detr4d_tpu/core/losses.py; reference: Detr3DHeadPE.loss /
loss_single, detr3d_head_pe.py:782-849).

Focal classification (gamma 2, alpha 0.25, weight 2.0) and weighted L1
regression (weight 0.25, code_weights, non-finite targets masked), per
decoder layer, logged as d{i}.loss_cls / d{i}.loss_bbox. The layers are
computed together, as the JAX package vmaps them: one K4 launch matches
every layer and image, one K5 launch gives every layer's focal loss.

The reference's two `reduce_mean` sync points (the JAX package's
`lax.pmean`) are the identity on one GPU; multi-GPU training is not
ported yet.
"""

import torch

from ..config import HeadConfig, LossConfig
from ..geometry.boxes import normalize_bbox
from ..ops import focal_loss as focal_ops
from .matching import match_targets


def loss_single_layer(
    cls_scores: torch.Tensor,  # (layers, B, Q, C)
    bbox_preds: torch.Tensor,  # (layers, B, Q, 10)
    gt_bboxes: torch.Tensor,  # (B, G, 9)
    gt_labels: torch.Tensor,  # (B, G)
    gt_valid: torch.Tensor,  # (B, G)
    loss_cfg: LossConfig,
    head_cfg: HeadConfig,
):
    """The JAX package's `loss_single_layer` for every decoder layer at
    once (the leading axis), as `detr3d_loss` vmaps it. Returns
    (loss_cls, loss_bbox, num_total_pos), each of shape (layers,)."""
    layers, B, Q, C = cls_scores.shape

    def per_layer(t):
        return t[None].expand(layers, *t.shape)

    t = match_targets(
        cls_scores.detach(), bbox_preds.detach(), per_layer(gt_bboxes),
        per_layer(gt_labels), per_layer(gt_valid),
        num_classes=head_cfg.num_classes,
        cls_weight=loss_cfg.match_cls_weight,
        reg_weight=loss_cfg.match_reg_weight,
    )
    num_total_pos = t.num_pos.sum(-1)
    # classification avg factor = pos + bg_weight * neg (:822-828)
    cls_avg = num_total_pos + loss_cfg.bg_cls_weight * (B * Q - num_total_pos)
    cls_avg = cls_avg.clamp(min=1.0)
    loss_cls = loss_cfg.cls_weight * focal_ops.sigmoid_focal_loss(
        cls_scores.reshape(layers, B * Q, C).float(),
        t.labels.reshape(layers, B * Q),
        t.label_weights.reshape(layers, B * Q),
        cls_avg,
        alpha=loss_cfg.focal_alpha,
        gamma=loss_cfg.focal_gamma,
    )

    # regression: weighted L1 on normalized targets (:837-845)
    num_pos = num_total_pos.clamp(min=1.0)
    codes = normalize_bbox(t.bbox_targets.reshape(layers, B * Q, -1))
    finite = torch.isfinite(codes).all(-1, keepdim=True)
    codes = torch.where(finite, codes, 0.0)
    code_w = torch.tensor(head_cfg.code_weights, dtype=torch.float32,
                          device=codes.device)
    w = t.bbox_weights.reshape(layers, B * Q, 1) * finite.float() * code_w
    diff = (bbox_preds.reshape(layers, B * Q, -1).float() - codes).abs()
    loss_bbox = loss_cfg.bbox_weight * (diff * w).sum((1, 2)) / num_pos
    return (torch.nan_to_num(loss_cls), torch.nan_to_num(loss_bbox),
            num_total_pos)


def detr3d_loss(
    preds: dict,
    gt_bboxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    loss_cfg: LossConfig,
    head_cfg: HeadConfig,
):
    """Sum of the per-decoder-layer losses and a metrics dict of 0-d
    tensors named as the JAX package names them (:1013-1094)."""
    lcs, lbs, nposs = loss_single_layer(
        preds["all_cls_scores"], preds["all_bbox_preds"], gt_bboxes,
        gt_labels, gt_valid, loss_cfg, head_cfg,
    )
    total = lcs.sum() + lbs.sum()
    num_layers = lcs.shape[0]
    metrics = {}
    for lid in range(num_layers):
        tag = "" if lid == num_layers - 1 else f"d{lid}."
        metrics[f"{tag}loss_cls"] = lcs[lid]
        metrics[f"{tag}loss_bbox"] = lbs[lid]
    metrics["num_pos"] = nposs[-1]
    metrics["loss"] = total
    return total, metrics
