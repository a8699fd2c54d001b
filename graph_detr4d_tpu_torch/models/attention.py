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

With `depth_encode` the positional MLP also sees rho = sqrt(x^2 + y^2) of
the sigmoid-space reference point, appended before inverse_sigmoid
(deform3d_cross_attn.py:331-334; Linear(4, C) at :105).

With `fix_offset` the offset linear's weight and bias are detached in the
forward (the JAX module's stop_gradient): they get no gradient, the
query still does, and the parameters stay trainable, so AdamW's `main`
group still decays them as optax does (deform3d_cross_attn.py:64 sets
requires_grad=False instead, which freezes them outright).

Camera parallelism (`cam_shard`, a parallel/mesh.py Mesh with a cam
group, set by parallel/mesh.py's callers through
models/detector.py::shard_cameras): the rank holds cameras
[cam_index * n, (cam_index + 1) * n) of the N, samples and compacts only
those, and sums its part of the gated camera sum over the cam group.
The gate is computed for all N cameras and viewed as (B, N, Q) before the
rank's cameras are taken: the view mixes the query and camera axes, so
slicing the logits first would give other numbers.
"""

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..geometry.projection import (denormalize_points,
                                   project_points_to_cameras)
from ..parallel.mesh import all_reduce_sum
from ..utils.math import inverse_sigmoid
from .k1_graph import K1Module
from .layers import Linear, dropout, ln_mlp


def camera_slice(shard, n: int) -> slice:
    """The cameras [first, first + n) of the rig that a camera shard
    holding n of them reads (all n without a shard)."""
    first = 0 if shard is None else shard.cam_index * n
    return slice(first, first + n)


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


def offset_points(reference_points, offsets, pc_range, num_levels):
    """Each query's graph of offset points, metric, fp32 (B, Q, heads, L,
    P, 3), the same at every level: reference_points (B, Q, 3) in [0, 1]
    denormalised into pc_range plus offsets (B, Q, heads, 1, P, 3)."""
    B, Q, nh, _, P, _ = offsets.shape
    ref = denormalize_points(reference_points.float(), pc_range)
    return ref[:, :, None, None, None, :] + offsets.float().expand(
        B, Q, nh, num_levels, P, 3)


def camera_samples(pts, logits, lidar2img, img_shape):
    """K1's sampling locations and weights for the metric points pts (B,
    rows, heads, L, P, 3) with attention logits (B, rows, heads, L * P):
    every point projected into each of the n cameras of lidar2img (B, n,
    4, 4) (geometry/projection.py), the logits' softmax over L * P, the
    same for every camera, times the point's validity there. Returns (loc
    (B * n, rows, heads, L, P, 2), attn (B * n, rows, heads, L, P), both
    dense as K1 reads them, valid (B, n, rows, heads, L, P) float)."""
    B, rows, nh, L, P, _ = pts.shape
    n = lidar2img.shape[1]
    loc, valid = project_points_to_cameras(pts.reshape(B, -1, 3),
                                           lidar2img.float(), img_shape)
    valid = valid.view(B, n, rows, nh, L, P)
    attn = torch.softmax(logits.float(), dim=-1).view(B, 1, rows, nh, L, P)
    attn = attn * valid
    return (loc.reshape(B * n, rows, nh, L, P, 2).contiguous(),
            attn.reshape(B * n, rows, nh, L, P).contiguous(), valid)


class Deform3DCrossAttn(K1Module):
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
        depth_encode: bool = False,
        fix_offset: bool = False,
    ):
        super().__init__()
        C = embed_dims
        self.dropout = dropout
        self.num_heads, self.num_levels = num_heads, num_levels
        self.num_points, self.num_cams = num_points, num_cams
        self.pc_range = tuple(pc_range)
        self.cam_capacity = cam_capacity
        self.depth_encode = depth_encode
        self.fix_offset = fix_offset
        self.cam_shard = None  # a Mesh with a cam group, or None
        self.cam_attention_weights = Linear(C, num_cams)
        self.deform_sampling_offsets = Linear(C, num_heads * num_points * 3)
        self.attention_weights = Linear(C, num_heads * num_levels * num_points)
        self.value_proj = Linear(C, C)
        self.output_proj = Linear(C, C)
        self.position_encoder = ln_mlp(4 if depth_encode else 3, C)

    def steps(
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
        """forward as a generator of its one K1 call (models/k1_graph.py).
        Before it: the gate logits, the offsets and their projection into
        every camera, the validity mask, the softmax, value_proj and the
        compaction's query list; after it: K1's output scattered back to
        every query, the camera gate's sum, output_proj, dropout, the
        residual and the positional MLP. Returns (query update (B, Q, C),
        cam_overflow scalar tensor): the overflow counts in-view queries
        the compaction dropped (0 means the compaction was exact)."""
        B, Q, C = query.shape
        nh, L, P, N = (self.num_heads, self.num_levels, self.num_points,
                       self.num_cams)
        n = lidar2img.shape[1]  # the cameras this rank holds
        q = query + query_pos
        gate_logits = self.cam_attention_weights(q)  # (B, Q, N)
        lin = self.deform_sampling_offsets
        if self.fix_offset:
            offsets = F.linear(q, lin.weight.detach().to(q.dtype),
                               lin.bias.detach().to(q.dtype))
        else:
            offsets = lin(q)
        # every node projected into every camera
        # (deform3d_cross_attn.py:232-252), weighted by the same logits
        loc, attn, valid = camera_samples(
            offset_points(reference_points, offsets.view(B, Q, nh, 1, P, 3),
                          self.pc_range, L),
            self.attention_weights(q).view(B, Q, nh, L * P), lidar2img,
            img_shape)
        value = self.value_proj(value).reshape(B * n, -1, nh, C // nh)

        K = min(Q, int(math.ceil(Q * self.cam_capacity)))
        if K < Q:
            anyv = valid.amax(dim=(3, 4, 5))  # (B, N, Q)
            # stable descending sort = jax.lax.top_k's order: in-view
            # queries first, lower index first among ties
            sel = torch.sort(anyv, dim=-1, descending=True,
                             stable=True).indices[..., :K]
            overflow = (anyv.sum(-1) - K).clamp(min=0.0).sum()
            sel = sel.reshape(B * n, K).contiguous()
        else:
            sel = None
            overflow = torch.zeros((), device=query.device)

        sampled = yield value, spatial_shapes, loc, attn, sel
        if sel is not None:
            sampled_sel = sampled
            sampled = torch.zeros(B * n, Q, C, dtype=sampled_sel.dtype,
                                  device=sampled_sel.device)
            sampled.scatter_(1, sel[..., None].expand(-1, -1, C), sampled_sel)
        sampled = sampled.view(B, n, Q, C)

        # REFERENCE QUIRK (checkpoint-parity load-bearing): the (B, Q, N)
        # gate becomes (B, N, Q, 1) by `.view`, a memory reinterpret of
        # the (Q, N)-contiguous tensor, NOT a transpose
        # (deform3d_cross_attn.py:211-212). A camera shard takes its
        # cameras after the view.
        gate = torch.sigmoid(gate_logits.float()).reshape(B, N, Q, 1)
        shard = self.cam_shard
        out = (sampled.float() * gate[:, camera_slice(shard, n)]).sum(dim=1)
        if shard is not None:
            out = all_reduce_sum(out, shard.cam_group)
            overflow = all_reduce_sum(overflow.detach(), shard.cam_group)
        out = dropout(self.output_proj(out.to(query.dtype)), self.dropout,
                      generator)

        ref_n = reference_points.float()
        if self.depth_encode:
            rho = torch.sqrt(ref_n[..., 0:1] ** 2 + ref_n[..., 1:2] ** 2)
            ref_n = torch.cat([ref_n, rho], dim=-1)
        pe = inverse_sigmoid(ref_n)
        pos_feat = self.position_encoder(pe.to(query.dtype))
        return out + query + pos_feat, overflow
