"""One distillation step (counterpart of the step body of
tools/distill_train.py: `_teacher_fwd_body` and `_student_train_body`):

    step = DistillStep(teacher, distiller, s_cfg, dcfg, seed=0)
    metrics = step.step(batch)   # batch: dict of tensors on the device

The frozen teacher runs once, in eval, under torch.no_grad: its features
(no grid mask), then its head on them. Then the student's forward (grid
mask and dropout from the step's generator) with, under MixDistill, the
teacher's query table for the second decode; the laterals; the loss
(distill/distiller.py::distill_loss); the backward; the clip and AdamW
over the student and the laterals only (train/optim.py with the student's
TrainConfig, the student's frozen parameters labelled as in a plain
step). The phases are methods of their own, so a caller can time them.
The metrics are 0-d tensors on the device, with `grad_norm` before the
clip.

Under a process group (`mesh`, parallel/mesh.py) each rank steps on its
share of the global batch, as train/step.py does: the student's set loss
syncs over the data group, the gradients are averaged over all ranks in
one all-reduce before the clip, and the metrics are the data group's
mean (the JAX CLI's --data-parallel mesh over the distill batch).
"""

import torch

from ..config import ModelConfig
from ..distill.distiller import DistillConfig, distill_loss
from ..parallel.mesh import Mesh, all_reduce_mean_
from .optim import build_optimizer, clip_by_global_norm
from .step import DATA_SEED_STRIDE, data_mean


class DistillStep:
    """Owns the teacher (frozen), the Distiller, the optimizer over the
    Distiller's parameters, its schedule and the random generator."""

    def __init__(self, teacher: torch.nn.Module, distiller: torch.nn.Module,
                 student_cfg: ModelConfig, dcfg: DistillConfig, seed: int = 0,
                 mesh: Mesh = None):
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        if self.mesh is not None and self.mesh.cam > 1:
            raise NotImplementedError(
                "a distill step shards the batch over a data mesh only (the "
                "JAX CLI's --data-parallel)")
        self.group = None if self.mesh is None else self.mesh.data_group
        self.teacher = teacher.eval().requires_grad_(False)
        self.distiller, self.cfg, self.dcfg = distiller, student_cfg, dcfg
        self.params = list(distiller.parameters())
        self.optimizer, self.scheduler = build_optimizer(distiller,
                                                         student_cfg.train)
        device = self.params[0].device
        self.generator = torch.Generator(device).manual_seed(
            seed + DATA_SEED_STRIDE * (self.mesh.data_index if self.mesh else 0))
        self.teacher_query_embed = (
            teacher.pts_bbox_head.query_embedding.weight if dcfg.mix else None)

    @torch.no_grad()
    def teacher_forward(self, batch: dict):
        """(teacher features, teacher outputs), one backbone pass."""
        feats = self.teacher.extract_feats(batch["images"])
        return feats, self.teacher.forward_feats(feats, batch["lidar2img"])

    def student_loss(self, batch: dict, t_feats, t_outs):
        """(total loss, metrics, student outputs) of the student's forward
        against the batch's GT and the teacher's outputs."""
        for p in self.params:
            p.grad = None
        s_outs, adapted = self.distiller(
            batch["images"], batch["lidar2img"], train=True,
            generator=self.generator,
            teacher_query_embed=self.teacher_query_embed)
        total, metrics = distill_loss(
            s_outs, adapted, t_outs, t_feats, batch["gt_bboxes"],
            batch["gt_labels"], batch["gt_valid"], self.cfg, self.dcfg,
            self.group)
        return total, metrics, s_outs

    def update(self, total: torch.Tensor) -> torch.Tensor:
        """Backward, clip and AdamW; returns the norm before the clip."""
        total.backward()
        for p in self.params:
            if p.grad is None:
                # a parameter the loss does not reach (the offsets under
                # head.fix_offset): optax still decays it
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.mesh is not None:
            all_reduce_mean_(grads)
        norm = clip_by_global_norm(grads, self.cfg.train.grad_clip_norm)
        self.optimizer.step()
        self.scheduler.step()
        return norm

    def step(self, batch: dict) -> dict:
        """batch: images (B, N, H, W, 3), lidar2img (B, N, 4, 4), gt_bboxes
        (B, G, 9), gt_labels (B, G), gt_valid (B, G) on the device.
        Returns the loss metrics and `grad_norm`."""
        t_feats, t_outs = self.teacher_forward(batch)
        total, metrics, _ = self.student_loss(batch, t_feats, t_outs)
        metrics["grad_norm"] = self.update(total)
        return data_mean(metrics, self.group)
