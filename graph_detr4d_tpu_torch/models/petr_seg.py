"""PETR with BEV-map segmentation (counterpart of
graph_detr4d_tpu/models/petr_seg.py; reference: Petr3D_seg and
models/dense_heads/petr_head_seg.py:108-905).

  * `PETRHeadSeg`: the PETR detection stream (models/petr_head.py, shared
    branches, the coordinate PE gated by `se`) plus `num_lane` lane
    queries on a sqrt(num_lane)^2 BEV grid (:365-369), embedded by
    `pos2posemb2d` (:540), decoded by a second decoder stack
    (`transformer_lane`, its own post_norm) over the same camera memory,
    layer by layer beside the detection stack (:546-548); one lane branch
    shared across layers maps each lane query to 768 logits, a 16x16
    patch of 3 map channels (:313-318, 573). `lane_branches` holds the
    shared branch at every index, as the reference's checkpoint does.
  * `lane_mask_loss`: the positive-balanced BCE of Sigmoid_ce_loss.py:
    19-43; `seg_iou`: the IoU metric of petr3d_seg.py:25-29.
  * `maps_to_patches` / `patches_to_map`: the (3, 256, 256) map mask to
    (256, 768) lane targets and back (pipelines/loading.py:11-25).
"""

import math

import numpy as np
import torch
import torch.nn as nn

from ..config import HeadConfig
from .head import reg_branch
from .layers import Linear
from .petr_head import (PETRHead, petr_transformer, shared_or_per_layer,
                        sine_embed)

LANE_PATCH = 16
LANE_CHANNELS = 3
LANE_OUT = LANE_CHANNELS * LANE_PATCH * LANE_PATCH


def pos2posemb2d(pos: torch.Tensor, num_pos_feats: int = 128,
                 temperature: float = 10000.0) -> torch.Tensor:
    """Sine embedding of normalised 2D positions (petr_head_seg.py:43-55):
    (..., 2) as (x, y) -> (..., 2 * num_pos_feats), **y first** (:54),
    unlike pos2posemb3d's (x, y, z)."""
    return sine_embed(pos, (1, 0), num_pos_feats, temperature)


def lane_grid(num_lane: int) -> np.ndarray:
    """(num_lane, 2) BEV grid of lane reference points: cell centres (i +
    0.5) / n of an n x n grid, n = sqrt(num_lane), in meshgrid 'ij' order
    (petr_head_seg.py:365-369)."""
    n = round(math.sqrt(num_lane))
    x = (np.arange(n, dtype=np.float32) + 0.5) / n
    xv, yv = np.meshgrid(x, x, indexing="ij")
    return np.stack([xv.reshape(-1), yv.reshape(-1)], -1)


def maps_to_patches(gt_map: np.ndarray, patch: int = LANE_PATCH) -> np.ndarray:
    """(C, H, W) map mask -> (num_patches, C * patch * patch) lane targets
    (LoadMapsFromFiles, loading.py:19-24): row-major patch grid,
    channel-major within a patch."""
    c, h, w = gt_map.shape
    gh, gw = h // patch, w // patch
    x = gt_map.reshape(c, gh, patch, gw, patch).transpose(1, 3, 0, 2, 4)
    return x.reshape(gh * gw, c * patch * patch)


def patches_to_map(patches: torch.Tensor, channels: int = LANE_CHANNELS,
                   patch: int = LANE_PATCH) -> torch.Tensor:
    """The inverse of maps_to_patches: (P, C * p * p) -> (C, H, W)."""
    g = round(math.sqrt(patches.shape[0]))
    x = patches.reshape(g, g, channels, patch, patch).permute(2, 0, 3, 1, 4)
    return x.reshape(channels, g * patch, g * patch)


def lane_mask_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Positive-balanced BCE with logits (Sigmoid_ce_loss.py:26-43): each
    row (last axis) weighs its positives by pos_weight = #neg / max(#pos,
    1); the mean over every element. For (B, P, D) inputs this is the
    mean over the batch of each sample's loss, as the JAX step's vmap."""
    targets = targets.float()
    logits = logits.float()
    pos = (targets == 1).float().sum(-1, keepdim=True)
    neg = (targets == 0).float().sum(-1, keepdim=True)
    pos_weight = neg / pos.clamp(min=1.0)
    w = targets * pos_weight + (1.0 - targets)
    ce = (logits.clamp(min=0) - logits * targets
          + torch.log1p(torch.exp(-logits.abs())))
    return (w * ce).mean()


def seg_iou(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Soft dice-style IoU per class row (petr3d_seg.py:25-29):
    (2 sum(p t) + 0.01) / (sum p + sum t + 0.01)."""
    num = 2.0 * (pred * target).sum(1)
    den = pred.sum(1) + target.sum(1)
    return (num + 0.01) / (den + 0.01)


class PETRHeadSeg(PETRHead):
    """PETR detection + BEV-map segmentation. with_time: the rig carries
    past-frame cameras (models/detector.py); with_se: the SE gate on the
    coordinate PE, named `se` (petr_head_seg.py:362-363, 507-508)."""

    GATE = "se"

    def __init__(self, cfg: HeadConfig, img_shape, in_channels: int,
                 with_time: bool = False, with_se: bool = False):
        super().__init__(cfg, img_shape, in_channels, with_time=with_time,
                         with_fpe=with_se)
        C = cfg.embed_dims
        self.query_embedding_lane = nn.Sequential(
            Linear(cfg.pe_num_feats * 2, C), nn.ReLU(), Linear(C, C))
        self.transformer_lane = petr_transformer(cfg)
        self.lane_branches = shared_or_per_layer(
            # [Linear, ReLU] x num_reg_fcs + Linear(768): the reg branch's
            lambda: reg_branch(C, LANE_OUT, cfg.num_reg_fcs),
            cfg.num_decoder_layers, per_layer=False)

    def forward(self, mlvl_feats, lidar2img, generator=None,
                mean_time_stamp=None):
        """As PETRHead.forward, plus 'all_lane_preds' (layers, B, num_lane,
        768) fp32 logits."""
        cfg = self.cfg
        memory, key_pos, _ = self.memory(mlvl_feats[0], lidar2img)
        B, dtype = memory.shape[0], memory.dtype
        query, query_pos, ref_is = self.queries(B, dtype)
        grid = torch.from_numpy(lane_grid(cfg.num_lane)).to(memory.device)
        lane_pos = self.query_embedding_lane(
            pos2posemb2d(grid, cfg.pe_num_feats).to(dtype))
        lane_pos = lane_pos[None].expand(B, -1, -1)
        lane_query = torch.zeros_like(lane_pos)
        dec, lane_dec = self.transformer.decoder, self.transformer_lane.decoder
        cls_scores, bbox_preds, lane_preds = [], [], []
        for lid in range(cfg.num_decoder_layers):
            query = dec.layers[lid](query, query_pos, memory, key_pos,
                                    generator)
            lane_query = lane_dec.layers[lid](lane_query, lane_pos, memory,
                                              key_pos, generator)
            inter = dec.post_norm(query)
            cls_scores.append(self.cls_branches[lid](inter).float())
            bbox_preds.append(self.decode_boxes(
                self.reg_branches[lid](inter).float(), ref_is,
                mean_time_stamp))
            lane_preds.append(self.lane_branches[lid](
                lane_dec.post_norm(lane_query)).float())
        return {"all_cls_scores": torch.stack(cls_scores),
                "all_bbox_preds": torch.stack(bbox_preds),
                "all_lane_preds": torch.stack(lane_preds),
                "cam_overflow": torch.zeros((), device=memory.device)}
