"""Distillation losses: the soft-label matching cost, the soft binary
cross-entropy and the feature loss (counterpart of
graph_detr4d_tpu/distill/losses.py).

Reference:
  * DistillCrossEntropyLossCost (core/bbox/match_costs/match_cost.py:30-92):
    the BCE cost between student logits and teacher sigmoid scores;
  * DistillCrossEntropyLoss (models/losses/distill_cross_entropy_loss.py:
    151-250): soft-label binary CE on the matched pairs;
  * DistillHungarianAssigner3D: every teacher query a soft GT row;
  * the feature loss 'vanilla' / 'attention' (distillers/
    detr4d_distiller.py:121-141): per-level MSE, optionally weighted by the
    teacher's spatial and channel softmax attention (T = 0.5).

Every function takes any leading batch axes, so `match_soft_targets`
solves the problems of every image and decoder stage in one launch of K4
(ops/hungarian.py).
"""

from typing import Sequence

import torch
import torch.nn.functional as F

from ..ops import hungarian as lsa_ops


def bce_cost_matrix(student_logits: torch.Tensor,
                    teacher_scores: torch.Tensor) -> torch.Tensor:
    """(..., Qs, C) logits x (..., Qt, C) soft scores -> (..., Qs, Qt) BCE
    cost, summed over classes: the reference computes the class count and
    never divides by it (match_cost.py:56-78)."""
    s = student_logits.float()
    t = teacher_scores.float()
    log_p, log_np = F.logsigmoid(s), F.logsigmoid(-s)
    return -(log_p @ t.transpose(-1, -2) + log_np @ (1.0 - t).transpose(-1, -2))


def soft_binary_cross_entropy(student_logits, soft_labels, weights,
                              avg_factor):
    """Soft-label BCE of (..., Q, C) logits against (..., Q, C) scores,
    weighted per query by (..., Q) and divided by avg_factor (...)."""
    s = student_logits.float()
    t = soft_labels.float()
    bce = -(t * F.logsigmoid(s) + (1.0 - t) * F.logsigmoid(-s))
    return (bce * weights[..., None]).sum((-1, -2)) / avg_factor


@torch.no_grad()
def match_soft_targets(student_logits, student_codes, teacher_scores,
                       teacher_codes, *, cls_weight: float = 1.0,
                       reg_weight: float = 0.25) -> torch.Tensor:
    """The Hungarian over soft costs, teacher queries as rows: (..., Qt)
    the student query each teacher row is given (all solved, Qt <= Qs).
    Costs: cls_weight x bce_cost_matrix + reg_weight x the L1 over the
    first 8 code dims."""
    reg = (student_codes[..., :, None, :8].float()
           - teacher_codes[..., None, :, :8].float()).abs().sum(-1)
    cost = cls_weight * bce_cost_matrix(student_logits, teacher_scores)
    cost = cost + reg_weight * reg  # (..., Qs, Qt)
    lead, (Qs, Qt) = cost.shape[:-2], cost.shape[-2:]
    t_for_s = lsa_ops.hungarian_assignment(
        cost.transpose(-1, -2).reshape(-1, Qt, Qs).contiguous())
    return t_for_s.long().reshape(*lead, Qt)


def feat_distill_loss(teacher_feats: Sequence[torch.Tensor],
                      student_feats_adapted: Sequence[torch.Tensor],
                      kind: str = "vanilla", temperature: float = 0.5):
    """Per-level MSE (with kind 'attention', weighted by the teacher's
    spatial and channel saliency) averaged over the levels. Levels are L x
    (B, N, H, W, C); a level-count mismatch raises."""
    if len(teacher_feats) != len(student_feats_adapted):
        raise ValueError(
            f"feature-distill level mismatch: teacher has "
            f"{len(teacher_feats)} levels, student "
            f"{len(student_feats_adapted)}"
        )
    if kind not in ("vanilla", "attention"):
        raise ValueError(kind)
    total = 0.0
    for t, s in zip(teacher_feats, student_feats_adapted):
        B, N, H, W, C = t.shape
        tf = t.float().reshape(B * N, H * W, C)
        sf = s.float().reshape(B * N, H * W, C)
        mse = (tf - sf) ** 2
        if kind == "vanilla":
            total = total + mse.mean()
        else:
            g_c = tf.abs().mean(-1)  # (BN, HW) spatial saliency
            a_c = (H * W) * torch.softmax(g_c / temperature, dim=1)
            g_s = tf.abs().mean(1)  # (BN, C) channel saliency
            a_s = C * torch.softmax(g_s / temperature, dim=1)
            total = total + (a_c[:, :, None] * a_s[:, None, :] * mse).mean()
    return total / len(teacher_feats)
