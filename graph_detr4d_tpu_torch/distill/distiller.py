"""Teacher -> student distillation (counterpart of
graph_detr4d_tpu/distill/distiller.py; reference Detr4D_Distiller and
MixDistill, distillation/distillers/detr4d_distiller.py:12-179,
mix_distill.py:12-116).

A step (train/distill_step.py): the frozen teacher's features and outputs,
then the student's, then the student's GT loss plus
  * instance distillation, per decoder stage: the teacher's sigmoid
    scores and boxes are soft GT, matched to the student's queries by the
    soft Hungarian (distill/losses.py);
  * MixDistill: the same on the student's second decode of the teacher's
    query table (models/head.py, `teacher_query_embed`);
  * feature distillation: per-level MSE between the teacher's FPN levels
    and the student's through 1x1 lateral convs.
Only the student and the laterals train (apis/mmdet_distill_train.py:
88-92).
"""

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..config import ModelConfig
from ..core.losses import detr3d_loss
from ..geometry.boxes import denormalize_bbox, normalize_bbox
from ..models.detector import GraphDETR4D
from ..models.layers import PointwiseConv
from .losses import (feat_distill_loss, match_soft_targets,
                     soft_binary_cross_entropy)


@dataclass(frozen=True)
class DistillConfig:
    cls_distill_weight: float = 1.0
    reg_distill_weight: float = 0.25
    feat_distill_weight: float = 1.0
    feat_distill_kind: str = "vanilla"  # or 'attention'
    match_cls_weight: float = 1.0
    match_reg_weight: float = 0.25
    reweight_score: bool = False  # teacher's max score weights the reg loss
    use_feat_distill: bool = True
    use_instance_distill: bool = True
    # MixDistill: decode the teacher's query table a second time and
    # distill on those guided outputs
    mix: bool = False
    # soft-GT rows: the top-K teacher queries by max sigmoid score, or
    # None for all of them (the reference's square problem)
    teacher_top_k: Optional[int] = None


class Distiller(nn.Module):
    """The student and the per-level 1x1 lateral convs (with bias) that
    map its FPN levels to the teacher's width: the trainable scope."""

    def __init__(self, student_cfg: ModelConfig,
                 teacher_feat_channels: int = 256, device="cuda"):
        super().__init__()
        self.student = GraphDETR4D(student_cfg, device=device)
        self.lateral_convs = nn.ModuleList(
            PointwiseConv(student_cfg.neck.out_channels, teacher_feat_channels)
            for _ in range(student_cfg.neck.num_outs)
        )
        self.to(next(self.student.parameters()).device)

    def forward(self, images, lidar2img, train: bool = False, generator=None,
                teacher_query_embed=None):
        """(student outputs, the laterals applied to the student's
        levels). train=True draws the grid mask and dropout from
        `generator`."""
        if not train:
            generator = None
        elif generator is None:
            raise ValueError("train=True needs a generator for the grid "
                             "mask and dropout")
        feats = self.student.extract_feats(images, generator)
        outs = self.student.forward_feats(
            feats, lidar2img, generator,
            teacher_query_embed=teacher_query_embed)
        return outs, [conv(f) for conv, f in zip(self.lateral_convs, feats)]


def top_k_rows(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(..., k) indices of the k largest of (..., Q), largest first, ties
    to the lower index: jax.lax.top_k's order (a stable sort; torch.topk
    promises no order among ties)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def instance_distill_losses(teacher_outs: dict, student_outs: Sequence[dict],
                            code_weights, dcfg: DistillConfig):
    """Per-stage soft distillation of each dict of student outputs against
    the teacher's (detr4d_distiller.py:143-168, detr3d_head_pe.py
    loss_distill_single:851-1011). Every stage, image and dict is matched
    in one K4 launch (one a dict where their query counts differ).
    Returns [(cls loss, reg loss)] per dict, each the per-image loss
    averaged over the batch and summed over the stages, times the
    configured weight."""
    if len({o["all_cls_scores"].shape for o in student_outs}) > 1:
        return [losses for o in student_outs for losses in
                instance_distill_losses(teacher_outs, [o], code_weights, dcfg)]
    t_cls = teacher_outs["all_cls_scores"].detach().float()
    t_bbox = teacher_outs["all_bbox_preds"].detach().float()
    S, B, Qt, C = t_cls.shape
    t_scores = torch.sigmoid(t_cls)
    # the reference denormalises the teacher's codes and re-normalises
    # them: (sin, cos) come back onto the unit circle
    t_codes = normalize_bbox(denormalize_bbox(t_bbox))
    k = dcfg.teacher_top_k
    if k is not None and k < Qt:
        idx = top_k_rows(t_scores.max(-1).values, k)
        t_scores = t_scores.gather(2, idx[..., None].expand(-1, -1, -1, C))
        t_codes = t_codes.gather(
            2, idx[..., None].expand(-1, -1, -1, t_codes.shape[-1]))
    n = len(student_outs)
    s_cls = torch.stack([o["all_cls_scores"] for o in student_outs])
    s_bbox = torch.stack([o["all_bbox_preds"] for o in student_outs])
    Qs = s_cls.shape[3]
    rep = (n, S, B, -1, -1)
    t_for_s = match_soft_targets(
        s_cls.detach(), s_bbox.detach(), t_scores.expand(rep),
        t_codes.expand(rep), cls_weight=dcfg.match_cls_weight,
        reg_weight=dcfg.match_reg_weight)  # (n, S, B, K)
    K = t_for_s.shape[-1]
    t_scores, t_codes = t_scores.expand(rep), t_codes.expand(rep)

    def scatter(src):
        out = torch.zeros(n, S, B, Qs, src.shape[-1], device=src.device)
        return out.scatter_(3, t_for_s[..., None].expand(-1, -1, -1, -1,
                                                          src.shape[-1]), src)

    soft = scatter(t_scores)
    codes_t = scatter(t_codes)
    w = torch.zeros(n, S, B, Qs, device=t_cls.device).scatter_(
        3, t_for_s, torch.ones(n, S, B, K, device=t_cls.device))
    avg = w.sum(-1).clamp(min=1.0)
    lc = soft_binary_cross_entropy(s_cls, soft, w, avg)  # (n, S, B)
    rw, avg_reg = w, avg
    if dcfg.reweight_score:
        rw = w * torch.zeros_like(w).scatter_(3, t_for_s,
                                              t_scores.max(-1).values)
        # the avg factor re-based on the matched scores' sum
        # (detr3d_head_pe.py:907-911)
        avg_reg = rw.sum(-1).clamp(min=1.0)
    cw = torch.tensor([1.0] if code_weights is None else code_weights,
                      dtype=torch.float32, device=t_cls.device)
    l1 = ((s_bbox.float() - codes_t).abs() * cw).sum(-1)
    lr = (l1 * rw).sum(-1) / avg_reg
    return [(dcfg.cls_distill_weight * lc[i].mean(-1).sum(),
             dcfg.reg_distill_weight * lr[i].mean(-1).sum()) for i in range(n)]


def instance_distill_loss(teacher_outs: dict, student_outs: dict,
                          code_weights, dcfg: DistillConfig):
    """(cls loss, reg loss) of one dict of student outputs."""
    return instance_distill_losses(teacher_outs, [student_outs],
                                   code_weights, dcfg)[0]


def distill_loss(student_outs: dict, student_adapted_feats, teacher_outs: dict,
                 teacher_feats, gt_bboxes, gt_labels, gt_valid,
                 cfg: ModelConfig, dcfg: DistillConfig, group=None):
    """(total loss, metrics): the student's GT set loss (detr3d_loss, its
    sync points over the data `group`, where JAX passes axis_name) plus
    `distill_loss_cls` / `_reg`, with mix `mix_loss_cls` / `_reg` (raises
    when the student emitted no guided outputs) and `feat_loss`; `loss`
    the total. The metrics are 0-d tensors, named as the JAX package
    names them."""
    total, metrics = detr3d_loss(student_outs, gt_bboxes, gt_labels, gt_valid,
                                 cfg.loss, cfg.head, group)
    if dcfg.mix and "all_cls_scores_guided" not in student_outs:
        # a silently dropped MixDistill term would train a plain distill
        # run while the config claims mix
        raise ValueError(
            "DistillConfig.mix=True but the student head emitted no guided "
            "outputs: pass teacher_query_embed through the student forward")
    heads = [("distill_loss", student_outs)] if dcfg.use_instance_distill else []
    if dcfg.mix:
        heads.append(("mix_loss", {
            "all_cls_scores": student_outs["all_cls_scores_guided"],
            "all_bbox_preds": student_outs["all_bbox_preds_guided"]}))
    if heads:
        losses = instance_distill_losses(
            teacher_outs, [o for _, o in heads], cfg.head.code_weights, dcfg)
        for (tag, _), (lc, lr) in zip(heads, losses):
            metrics[f"{tag}_cls"] = lc
            metrics[f"{tag}_reg"] = lr
            total = total + lc + lr
    if dcfg.use_feat_distill:
        lf = dcfg.feat_distill_weight * feat_distill_loss(
            [f.detach() for f in teacher_feats], student_adapted_feats,
            kind=dcfg.feat_distill_kind)
        metrics["feat_loss"] = lf
        total = total + lf
    metrics["loss"] = total
    return total, metrics
