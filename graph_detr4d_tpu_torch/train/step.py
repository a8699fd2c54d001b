"""One training step: forward, set loss, backward, clipped AdamW update
(counterpart of graph_detr4d_tpu/parallel/step.py::build_train_step and
init_state, on one GPU).

    step = TrainStep(model, cfg, seed=0)
    metrics = step.step(batch)   # batch: dict of tensors on the model's device

The step differentiates every parameter, the frozen stages included, as
the JAX step does (train/optim.py). The metrics are 0-d tensors on the
device: reading them is the caller's sync.
"""

import torch

from ..config import ModelConfig
from ..core.losses import detr3d_loss, hybrid_detr3d_loss
from ..models.detector import model_extras
from .optim import build_optimizer, clip_by_global_norm


class TrainStep:
    """Owns the model, the AdamW optimizer, its schedule and the random
    generator the grid mask and dropout draw from."""

    def __init__(self, model: torch.nn.Module, cfg: ModelConfig, seed: int = 0):
        if cfg.head.fix_offset:
            raise NotImplementedError(
                "graph_detr4d_tpu_torch does not train head.fix_offset yet")
        self.model, self.cfg = model, cfg
        # H-DETR heads emit a one2many group with its own set loss
        # (h_detr3d_head_pe.py:616-668)
        self.loss_fn = (hybrid_detr3d_loss if cfg.head.num_query_one2many > 0
                        else detr3d_loss)
        self.params = list(model.parameters())
        self.optimizer, self.scheduler = build_optimizer(model, cfg.train)
        device = self.params[0].device
        self.generator = torch.Generator(device).manual_seed(seed)

    def step(self, batch: dict) -> dict:
        """batch: images (B, N, H, W, 3), lidar2img (B, N, 4, 4), gt_bboxes
        (B, G, 9), gt_labels (B, G), gt_valid (B, G), on the model's
        device, and where the batch has them depth_factors, intrinsics and
        ida_scale (models/detector.py::MODEL_EXTRAS). Returns the loss metrics and `grad_norm`
        (before clipping)."""
        for p in self.params:
            p.grad = None
        out = self.model(batch["images"], batch["lidar2img"], train=True,
                         generator=self.generator, **model_extras(batch))
        total, metrics = self.loss_fn(
            out, batch["gt_bboxes"], batch["gt_labels"], batch["gt_valid"],
            self.cfg.loss, self.cfg.head,
        )
        total.backward()
        grads = [p.grad for p in self.params if p.grad is not None]
        metrics["grad_norm"] = clip_by_global_norm(
            grads, self.cfg.train.grad_clip_norm)
        self.optimizer.step()
        self.scheduler.step()
        return {k: v.detach() for k, v in metrics.items()}
