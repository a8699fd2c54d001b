"""One training step: forward, set loss, backward, clipped AdamW update
(counterpart of graph_detr4d_tpu/parallel/step.py::build_train_step and
init_state).

    step = TrainStep(model, cfg, seed=0)
    metrics = step.step(batch)   # batch: dict of tensors on the model's device

The step differentiates every parameter, the frozen stages included, as
the JAX step does (train/optim.py). The metrics are 0-d tensors on the
device: reading them is the caller's sync.

Under a process group (`mesh`, parallel/mesh.py) each rank steps on its
share of the global batch (and, on a cam group, its cameras): the loss
syncs its avg factors over the data group, every gradient is averaged
over all ranks in one coalesced all-reduce before the clip, so the clip
and `grad_norm` see the global gradient, and the metrics are the data
group's mean (`num_pos` its sum): the JAX step's over the global batch.
The grid mask and dropout draw from a generator seeded by the data rank,
the same on every rank of a cam group.
"""

import torch
import torch.distributed

from ..config import ModelConfig
from ..core.losses import detr3d_loss, hybrid_detr3d_loss
from ..models.detector import model_extras, shard_cameras
from ..models.petr_seg import lane_mask_loss
from ..parallel.mesh import Mesh, all_reduce_mean_, reduce_mean
from .optim import build_optimizer, clip_by_global_norm


# the generator seed's offset a data rank (the JAX CLI's per-rank seed)
DATA_SEED_STRIDE = 100003


class TrainStep:
    """Owns the model, the AdamW optimizer, its schedule and the random
    generator the grid mask and dropout draw from."""

    def __init__(self, model: torch.nn.Module, cfg: ModelConfig, seed: int = 0,
                 mesh: Mesh = None):
        self.model, self.cfg = model, cfg
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        shard_cameras(model, self.mesh)
        self.group = None if self.mesh is None else self.mesh.data_group
        # H-DETR heads emit a one2many group with its own set loss
        # (h_detr3d_head_pe.py:616-668)
        self.loss_fn = (hybrid_detr3d_loss if cfg.head.num_query_one2many > 0
                        else detr3d_loss)
        self.params = list(model.parameters())
        self.optimizer, self.scheduler = build_optimizer(model, cfg.train)
        device = self.params[0].device
        self.generator = torch.Generator(device).manual_seed(
            seed + DATA_SEED_STRIDE * (self.mesh.data_index if self.mesh else 0))
        self.reduced_bytes = 0  # the last step's gradient all-reduce

    def loss(self, batch: dict):
        """The training forward and its loss: (total, metrics of 0-d
        tensors). batch: images (B, N, H, W, 3), lidar2img (B, N, 4, 4),
        gt_bboxes (B, G, 9), gt_labels (B, G), gt_valid (B, G), on the
        model's device, and where the batch has them the model extras
        (models/detector.py::MODEL_EXTRAS) and PETR-seg's lane targets
        `maps` (B, P, 768)."""
        out = self.model(batch["images"], batch["lidar2img"], train=True,
                         generator=self.generator, **model_extras(batch))
        total, metrics = self.loss_fn(
            out, batch["gt_bboxes"], batch["gt_labels"], batch["gt_valid"],
            self.cfg.loss, self.cfg.head, self.group,
        )
        if "all_lane_preds" in out and "maps" in batch:
            # PETR-seg: each layer's positive-balanced BCE on the lane
            # patches, summed over layers (the JAX step, parallel/step.py:
            # 85-96)
            lane = sum(lane_mask_loss(p, batch["maps"])
                       for p in out["all_lane_preds"])
            metrics["loss_mask"] = lane
            total = total + lane
            metrics["loss"] = total
        return total, metrics

    def step(self, batch: dict) -> dict:
        """One step on `batch` (see `loss`). Returns the loss metrics and
        `grad_norm` (before clipping)."""
        for p in self.params:
            p.grad = None
        total, metrics = self.loss(batch)
        total.backward()
        for p in self.params:
            if p.grad is None:
                # a parameter the loss does not reach (the FPN levels a
                # PETR head does not read): optax still decays it
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.mesh is not None:
            self.reduced_bytes = all_reduce_mean_(grads)
        metrics["grad_norm"] = clip_by_global_norm(
            grads, self.cfg.train.grad_clip_norm)
        self.optimizer.step()
        self.scheduler.step()
        return data_mean(metrics, self.group)


# metrics that count over the batch: the data group's sum, the global
# batch's count the JAX step reports
SUMMED_METRICS = ("num_pos",)


def data_mean(metrics: dict, group) -> dict:
    """The metrics, detached, as their mean over the data `group` (one
    all-reduce of the stacked values), SUMMED_METRICS as their sum: each
    the JAX step's value over the global batch. As they are without a
    group."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    if group is None:
        return metrics
    keys = sorted(metrics)
    packed = reduce_mean(torch.stack([metrics[k].float() for k in keys]),
                         group)
    size = torch.distributed.get_world_size(group)
    return {k: packed[i] * size if k in SUMMED_METRICS else packed[i]
            for i, k in enumerate(keys)}
