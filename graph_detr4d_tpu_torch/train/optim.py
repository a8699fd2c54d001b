"""Optimizer: AdamW, parameter groups, warmup + cosine schedule, clip
(counterpart of graph_detr4d_tpu/train/optim.py; reference:
configs/detr4d/...12e.py:201-216).

AdamW at lr 2e-4 and weight decay 0.01 on every trainable parameter,
backbone lr x0.1, gradients clipped to a global L2 norm of 35, cosine
annealing to min_lr_ratio 1e-3 after a 500-step linear warmup from 1/3,
evaluated at the 0-based update count as optax does.

The frozen parameters follow the JAX step, not upstream: their
parameters keep requires_grad, so their gradients enter the clip norm and
`grad_norm`, and only their update is zero (they are left out of the
optimizer, optax's `set_to_zero`). Which they are is the JAX rule
(train/optim.py:35-45): in the backbone, every parameter whose path names
`stem` or `layer1`. Each backbone class states that rule on its own
parameter names (`is_frozen`): ResNet's stem and layer1, VoVNet's stem
and every OSA block's second conv, MobileNetV2's stem. A parameter is a
backbone's wherever `img_backbone` is one of its name's parts, so a
Distiller's `student.img_backbone.*` is labelled as the bare model's.
"""

import math
from typing import Dict, List

import torch

from ..config import TrainConfig
from ..models.resnet import ResNet

BACKBONE = "img_backbone"


def lr_factor(cfg: TrainConfig, step: int) -> float:
    """The schedule's multiple of cfg.lr at update `step` (0-based)."""
    warm = min(cfg.warmup_ratio + (1.0 - cfg.warmup_ratio)
               * (step / cfg.warmup_iters), 1.0)
    progress = min(max(step / cfg.total_steps, 0.0), 1.0)
    cos = cfg.min_lr_ratio + 0.5 * (1.0 - cfg.min_lr_ratio) * (
        1.0 + math.cos(math.pi * progress))
    return warm * cos


def param_label(name: str, is_frozen=ResNet.is_frozen) -> str:
    """'frozen', 'backbone' (lr x0.1) or 'main', by the reference's
    parameter name; `is_frozen` is the backbone class's rule on names
    relative to it (default ResNet's)."""
    parts = name.split(".")
    if BACKBONE not in parts:
        return "main"
    rel = ".".join(parts[parts.index(BACKBONE) + 1:])
    return "frozen" if is_frozen(rel) else "backbone"


def param_labels(model: torch.nn.Module) -> Dict[str, str]:
    """{parameter name: param_label} for every parameter of `model`, each
    backbone's parameters under that backbone class's rule."""
    rules = {name + ".": type(m).is_frozen
             for name, m in model.named_modules()
             if name.split(".")[-1] == BACKBONE}
    labels = {}
    for name, _ in model.named_parameters():
        rule = next((r for prefix, r in rules.items()
                     if name.startswith(prefix)), ResNet.is_frozen)
        labels[name] = param_label(name, rule)
    return labels


def build_optimizer(model: torch.nn.Module, cfg: TrainConfig):
    """(AdamW over the backbone and main groups, its LambdaLR schedule)."""
    groups: Dict[str, List[torch.nn.Parameter]] = {
        "frozen": [], "backbone": [], "main": []}
    labels = param_labels(model)
    for name, p in model.named_parameters():
        groups[labels[name]].append(p)
    optimizer = torch.optim.AdamW(
        [{"params": groups["backbone"], "lr": cfg.lr * cfg.backbone_lr_mult},
         {"params": groups["main"], "lr": cfg.lr}],
        lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=cfg.weight_decay,
    )
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: lr_factor(cfg, step))
    return optimizer, scheduler


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float):
    """optax.clip_by_global_norm in place: if the global L2 norm is at least
    max_norm, scale every gradient by max_norm / norm (no epsilon, unlike
    torch.nn.utils.clip_grad_norm_). Returns the norm before clipping, as
    a 0-d tensor; no host sync."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm
