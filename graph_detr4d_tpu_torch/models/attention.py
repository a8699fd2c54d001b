"""Graph-structured 3D deformable cross-attention, the Graph-DETR4D core
(counterpart of graph_detr4d_tpu/models/attention.py; reference:
projects/mmdet3d_plugin/models/utils/deform3d_cross_attn.py:33-339):

  1. per-query learned 3D offsets (heads x points, circular-cone bias
     init) are added to the metric reference point,
  2. the graph of offset points is projected into every camera with
     in-front / in-image validity masks,
  3. multi-scale deformable attention (kernel K1, ops/msda.py) samples
     each camera's features with softmax(L*P) weights times the mask,
  4. a sigmoid per-camera gate sums over cameras,
  5. output projection + dropout + residual + positional MLP of the
     inverse-sigmoid reference point.

With `cam_capacity` < 1 each camera samples only its K = ceil(Q *
cam_capacity) queries that have any in-view sample; the rest contribute
exactly zero. The compaction is an index list that K1 reads directly.
"""

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..geometry.projection import denormalize_points
from ..ops import msda as msda_ops
from ..utils.math import inverse_sigmoid
from .layers import Linear, dropout, ln_mlp


def offset_bias_init(num_heads: int, num_points: int) -> np.ndarray:
    """Circular-cone 3D offset bias (deform3d_cross_attn.py:138-148)."""
    thetas = np.arange(num_heads, dtype=np.float32) * (
        2.0 * math.pi / num_heads
    )
    grid = np.stack([np.cos(thetas), np.sin(thetas), np.cos(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, 1, num_points, 1))
    for i in range(num_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


class Deform3DCrossAttn(nn.Module):
    def __init__(
        self,
        embed_dims: int = 256,
        num_heads: int = 8,
        num_levels: int = 4,
        num_points: int = 4,
        num_cams: int = 12,
        pc_range: Tuple[float, ...] = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
        cam_capacity: float = 1.0,
        dropout: float = 0.1,
    ):
        super().__init__()
        C = embed_dims
        self.dropout = dropout
        self.num_heads, self.num_levels = num_heads, num_levels
        self.num_points, self.num_cams = num_points, num_cams
        self.pc_range = tuple(pc_range)
        self.cam_capacity = cam_capacity
        self.cam_attention_weights = Linear(C, num_cams)
        self.deform_sampling_offsets = Linear(C, num_heads * num_points * 3)
        self.attention_weights = Linear(C, num_heads * num_levels * num_points)
        self.value_proj = Linear(C, C)
        self.output_proj = Linear(C, C)
        self.position_encoder = ln_mlp(3, C)

    def forward(
        self,
        query: torch.Tensor,  # (B, Q, C)
        value: torch.Tensor,  # (B, N, S, C): levels flattened, S = sum H*W
        spatial_shapes: Sequence[Tuple[int, int]],  # L x (H_l, W_l)
        query_pos: torch.Tensor,  # (B, Q, C)
        reference_points: torch.Tensor,  # (B, Q, 3) in [0, 1]
        lidar2img: torch.Tensor,  # (B, N, 4, 4)
        img_shape: Tuple[int, int],  # network input (H_img, W_img)
        generator=None,  # dropout's random source; None = eval
    ):
        """Returns (query update (B, Q, C), cam_overflow scalar tensor):
        the overflow counts in-view queries the compaction dropped (0 means
        the compaction was exact)."""
        B, Q, C = query.shape
        nh, L, P, N = (self.num_heads, self.num_levels, self.num_points,
                       self.num_cams)
        residual = query
        q = query + query_pos
        gate_logits = self.cam_attention_weights(q)  # (B, Q, N)
        offsets = self.deform_sampling_offsets(q).view(B, Q, nh, 1, P, 3)

        ref_metric = denormalize_points(reference_points.float(),
                                        self.pc_range)
        pts = ref_metric[:, :, None, None, None, :] + offsets.float().expand(
            B, Q, nh, L, P, 3
        )
        # project every node into every camera (deform3d_cross_attn.py:232-252)
        img_h, img_w = img_shape
        hom = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
        cam = torch.einsum("bnij,bqhlpj->bnqhlpi", lidar2img.float(), hom)
        eps = 1e-5
        z = cam[..., 2:3]
        xy = cam[..., 0:2] / z.clamp(min=eps)
        loc = xy / torch.tensor([img_w, img_h], dtype=xy.dtype,
                                device=xy.device)
        valid = (
            (z > eps)
            & (loc[..., 0:1] > 0.0) & (loc[..., 0:1] < 1.0)
            & (loc[..., 1:2] > 0.0) & (loc[..., 1:2] < 1.0)
        )[..., 0].float()  # (B, N, Q, heads, L, P)

        # the same logits for every camera, softmax over L*P, times the mask
        attn = self.attention_weights(q).view(B, Q, nh, L * P)
        attn = torch.softmax(attn.float(), dim=-1).view(B, 1, Q, nh, L, P)
        attn = attn * valid

        value = self.value_proj(value).reshape(B * N, -1, nh, C // nh)
        # einsum leaves the camera axis permuted in memory; K1 reads dense
        loc = loc.reshape(B * N, Q, nh, L, P, 2).contiguous()
        attn = attn.reshape(B * N, Q, nh, L, P).contiguous()

        K = min(Q, int(math.ceil(Q * self.cam_capacity)))
        if K < Q:
            anyv = valid.amax(dim=(3, 4, 5))  # (B, N, Q)
            # stable descending sort = jax.lax.top_k's order: in-view
            # queries first, lower index first among ties
            sel = torch.sort(anyv, dim=-1, descending=True,
                             stable=True).indices[..., :K]
            overflow = (anyv.sum(-1) - K).clamp(min=0.0).sum()
            sel = sel.reshape(B * N, K).contiguous()
            sampled_sel = msda_ops.msda_forward(value, spatial_shapes, loc,
                                                attn, sel)
            sampled = torch.zeros(B * N, Q, C, dtype=sampled_sel.dtype,
                                  device=sampled_sel.device)
            sampled.scatter_(1, sel[..., None].expand(-1, -1, C), sampled_sel)
        else:
            overflow = torch.zeros((), device=query.device)
            sampled = msda_ops.msda_forward(value, spatial_shapes, loc, attn)
        sampled = sampled.view(B, N, Q, C)

        # REFERENCE QUIRK (checkpoint-parity load-bearing): the (B, Q, N)
        # gate becomes (B, N, Q, 1) by `.view`, a memory reinterpret of
        # the (Q, N)-contiguous tensor, NOT a transpose
        # (deform3d_cross_attn.py:211-212).
        gate = torch.sigmoid(gate_logits.float()).reshape(B, N, Q, 1)
        out = (sampled.float() * gate).sum(dim=1)
        out = dropout(self.output_proj(out.to(query.dtype)), self.dropout,
                      generator)

        pe = inverse_sigmoid(reference_points.float())
        pos_feat = self.position_encoder(pe.to(query.dtype))
        return out + residual + pos_feat, overflow
