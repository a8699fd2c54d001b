"""Cross-attention variants (counterpart of
graph_detr4d_tpu/models/attention_variants.py):

  * `Detr3DCrossAtten`, DETR3D's attention (reference:
    detr3d_transformer.py:229-438): one 3D reference point per query,
    bilinear-sampled in every camera and FPN level, combined by a sigmoid
    weight over (cameras x levels) times the in-view mask (one K1 call: one
    head as wide as the features, one point a level, the level sum in
    the kernel);
  * `Deform3DCrossAttnMP`, the graph multi-point variant
    (deform3d_cross_attn_multi_point.py:34-453): the deform3d centre
    branch, plus the 8 graph-neighbour reference points of each query
    sampled without offsets at max(P // 4, 1) points (one K1 call over
    all Q x 8 neighbour rows), per-camera gated, summed over cameras and
    neighbours, and fused with the centre by a learned 2-way softmax;
  * `Detr3DCrossAttenV2` (detr3d_transformer.py:441-710): per (camera,
    head, level, point) a learned 2D offset around the projected
    reference point, softmax over levels x points, times the in-view mask.

As for deform3d, sampling locations and attention weights enter K1 in
fp32 (the JAX modules cast them to the compute dtype first). Each module
returns (query update, cam_overflow), the overflow 0: none compacts.

Camera parallelism (`cam_shard`, a parallel/mesh.py Mesh with a cam
group, set by models/detector.py::shard_cameras): the rank holds cameras
[cam_index * n, (cam_index + 1) * n) of the N, projects into and samples
only those, and sums its part of each camera sum over the cam group
(`all_reduce_sum`). DETR3D's weights and DETR3D-v2's weights and offsets
are laid out (B, Q, N, ...) by the projection itself, so a rank takes its
cameras of that axis. MP's two gates are the reference's (B, Q, N) and
(B, K * Q, N) memory read as (B, N, .), so a rank takes its cameras after
that view, as Deform3DCrossAttn does; its neighbour sum is all-reduced
before the sum over neighbours, and the learned fusion sees the summed
branches.
"""

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..geometry.projection import denormalize_points
from ..ops import msda as msda_ops
from ..parallel.mesh import all_reduce_sum
from ..utils.math import inverse_sigmoid
from .attention import camera_slice
from .layers import Linear, dropout, ln_mlp

PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)


def project_to_cams(pts, lidar2img, img_shape, eps=1e-5):
    """pts (B, S, 3) metric -> loc (B, N, S, 2) in [0, 1] of the image,
    mask (B, N, S) float: in front of the camera and inside the image."""
    img_h, img_w = img_shape
    hom = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    cam = torch.einsum("bnij,bsj->bnsi", lidar2img.float(), hom)
    z = cam[..., 2:3]
    xy = cam[..., 0:2] / z.clamp(min=eps)
    loc = xy / torch.tensor([img_w, img_h], dtype=xy.dtype, device=xy.device)
    valid = ((z > eps) & (loc[..., 0:1] > 0.0) & (loc[..., 0:1] < 1.0)
             & (loc[..., 1:2] > 0.0) & (loc[..., 1:2] < 1.0))[..., 0]
    return loc, valid.float()


def sum_cameras(x: torch.Tensor, shard) -> torch.Tensor:
    """x (B, n, ...) summed over its camera axis and, on a camera shard,
    over the cam group."""
    x = x.sum(dim=1)
    return x if shard is None else all_reduce_sum(x, shard.cam_group)


def _position_feat(mlp, ref01, dtype):
    """The positional MLP every variant adds (`ln_mlp`: Linear-LN-ReLU x2)
    over the inverse-sigmoid reference point."""
    return mlp(inverse_sigmoid(ref01.float()).to(dtype))


def v2_offset_bias(num_cams, num_heads, num_levels, num_points):
    """Detr3DCrossAttenV2's circular 2D offset bias (:527-541)."""
    thetas = np.arange(num_heads, dtype=np.float32) * (2.0 * math.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[None, :, None, None, :],
                   (num_cams, 1, num_levels, num_points, 1))
    for i in range(num_points):
        grid[:, :, :, i, :] *= i + 1
    return grid.reshape(-1)


class Detr3DCrossAtten(nn.Module):
    def __init__(self, embed_dims=256, num_levels=4, num_points=1, num_cams=6,
                 pc_range: Tuple[float, ...] = PC_RANGE, dropout=0.1):
        super().__init__()
        self.dropout = dropout
        self.num_levels, self.num_points, self.num_cams = (
            num_levels, num_points, num_cams)
        self.pc_range = tuple(pc_range)
        self.cam_shard = None  # a Mesh with a cam group, or None
        self.attention_weights = Linear(
            embed_dims, num_cams * num_levels * num_points)
        self.output_proj = Linear(embed_dims, embed_dims)
        self.position_encoder = ln_mlp(3, embed_dims)

    def forward(self, query, value, spatial_shapes, query_pos,
                reference_points, lidar2img, img_shape, generator=None):
        """query (B, Q, C); value (B, N, S, C), the levels flattened;
        reference_points (B, Q, 3) in [0, 1]."""
        B, Q, C = query.shape
        N, L, P = self.num_cams, self.num_levels, self.num_points
        n = lidar2img.shape[1]  # the cameras this rank holds
        residual = query
        q = query + query_pos
        w = torch.sigmoid(self.attention_weights(q).float()).view(
            B, Q, N, P, L)[:, :, camera_slice(self.cam_shard, n)]
        loc, mask = project_to_cams(
            denormalize_points(reference_points.float(), self.pc_range),
            lidar2img, img_shape)
        w = w * mask.transpose(1, 2)[..., None, None]
        # every level sampled at the one projected point a camera and
        # weighted in one K1 call: one head of width C, one point a level.
        # K1 skips corners outside the image and points of weight 0, so
        # finite features give finite sums: the reference's nan_to_num of
        # the samples changes nothing.
        loc = loc.reshape(B * n, Q, 1, 1, 1, 2).expand(B * n, Q, 1, L, 1, 2)
        attn = w.sum(3).permute(0, 2, 1, 3).reshape(B * n, Q, 1, L, 1)
        sampled = msda_ops.msda_forward(
            value.reshape(B * n, -1, 1, C), spatial_shapes, loc.contiguous(),
            attn.contiguous())
        out = sum_cameras(sampled.view(B, n, Q, C).float(), self.cam_shard)
        out = dropout(self.output_proj(out.to(query.dtype)), self.dropout,
                      generator)
        pos = _position_feat(self.position_encoder, reference_points, query.dtype)
        return out + residual + pos, torch.zeros((), device=query.device)


class Deform3DCrossAttnMP(nn.Module):
    """Centre branch as Deform3DCrossAttn without query_pos (the MP
    variant never adds it, multi_point.py:220-221) and without the
    compaction; neighbour branch with the RAW (unsigmoided) camera gate of
    the neighbours' queries; both gates the reference's (B, Q, N) memory
    read as (B, N, Q), not transposed. Neighbour rows are neighbour-major
    (j * Q + q), as the JAX module lays them out."""

    def __init__(self, embed_dims=256, num_heads=8, num_levels=4, num_points=4,
                 num_cams=12, num_neighbors=8,
                 pc_range: Tuple[float, ...] = PC_RANGE, dropout=0.1):
        super().__init__()
        C = embed_dims
        self.dropout = dropout
        self.num_heads, self.num_levels = num_heads, num_levels
        self.num_points, self.num_cams = num_points, num_cams
        self.num_neighbors = num_neighbors
        self.pc_range = tuple(pc_range)
        self.cam_shard = None  # a Mesh with a cam group, or None
        pn = max(num_points // 4, 1)
        self.cam_attention_weights = Linear(C, num_cams)
        self.deform_sampling_offsets = Linear(C, num_heads * num_points * 3)
        self.value_proj = Linear(C, C)
        self.attention_weights = Linear(C, num_heads * num_levels * num_points)
        self.attention_weights_neighbor = Linear(C, num_heads * num_levels * pn)
        self.output_weight = Linear(2 * C, 2)
        self.output_proj = Linear(C, C)
        self.position_encoder = ln_mlp(3, C)

    def _sample(self, value, spatial_shapes, lidar2img, img_shape, pts, logits):
        """K1 over the rows of pts (B, rows, heads, L, P, 3), metric, with
        attention logits (B, rows, heads, L * P), projected into each of
        the n cameras of lidar2img (B, n, 4, 4). Returns (B, n, rows, C)."""
        B, rows, nh, L, P, _ = pts.shape
        n = lidar2img.shape[1]
        loc, mask = project_to_cams(pts.reshape(B, -1, 3), lidar2img, img_shape)
        loc = loc.reshape(B * n, rows, nh, L, P, 2)
        attn = torch.softmax(logits.float(), dim=-1).view(B, 1, rows, nh, L, P)
        attn = attn * mask.view(B, n, rows, nh, L, P)
        out = msda_ops.msda_forward(value, spatial_shapes, loc.contiguous(),
                                    attn.reshape(B * n, rows, nh, L, P).contiguous())
        return out.view(B, n, rows, -1)

    def forward(self, query, value, spatial_shapes, query_pos,
                reference_points, lidar2img, img_shape, generator=None):
        """reference_points (B, Q * (1 + K), 3) in [0, 1]: the queries'
        own, then their K graph neighbours', neighbour-major."""
        B, Q, C = query.shape
        nh, L, P, N, K = (self.num_heads, self.num_levels, self.num_points,
                          self.num_cams, self.num_neighbors)
        pn = max(P // 4, 1)
        n = lidar2img.shape[1]  # the cameras this rank holds
        cams = camera_slice(self.cam_shard, n)
        residual, q = query, query
        ref_c, ref_n = reference_points[:, :Q], reference_points[:, Q:]
        value = self.value_proj(value).reshape(B * n, -1, nh, C // nh)

        offsets = self.deform_sampling_offsets(q).view(B, Q, nh, 1, P, 3)
        pts = denormalize_points(ref_c.float(), self.pc_range)[
            :, :, None, None, None, :] + offsets.float().expand(B, Q, nh, L, P, 3)
        centre = self._sample(value, spatial_shapes, lidar2img, img_shape, pts,
                              self.attention_weights(q).view(B, Q, nh, L * P))
        gate = self.cam_attention_weights(q).float()  # (B, Q, N)
        gate_c = torch.sigmoid(gate).reshape(B, N, Q, 1)[:, cams]
        centre = (centre.float() * gate_c).sum(dim=1)

        # neighbour row j * Q + q takes query q's logits and raw gate; the
        # gate's (B, K * Q, N) rows are read as (B, N, K * Q) as the centre's
        pts_n = denormalize_points(ref_n.float(), self.pc_range)[
            :, :, None, None, None, :].expand(B, K * Q, nh, L, pn, 3)
        logits_n = self.attention_weights_neighbor(q).repeat(1, K, 1)
        nb = self._sample(value, spatial_shapes, lidar2img, img_shape, pts_n,
                          logits_n.view(B, K * Q, nh, L * pn))
        gate_n = gate.repeat(1, K, 1).reshape(B, N, K * Q, 1)[:, cams]
        nb = (nb.float() * gate_n).sum(dim=1)  # (B, K * Q, C)
        if self.cam_shard is not None:
            # both camera sums in one all-reduce, before the neighbour sum
            both = all_reduce_sum(torch.cat([centre, nb], dim=1),
                                  self.cam_shard.cam_group)
            centre, nb = both[:, :Q], both[:, Q:]
        nb = nb.reshape(B, K, Q, C).sum(dim=1)

        # learned global 2-way fusion, per sample (multi_point.py:436-439)
        fuse = self.output_weight(torch.cat([centre, nb], -1).to(query.dtype))
        fuse = torch.softmax(fuse.float().sum(dim=1), dim=-1)  # (B, 2)
        out = centre * fuse[:, None, 0:1] + nb * fuse[:, None, 1:2]
        out = dropout(self.output_proj(out.to(query.dtype)), self.dropout,
                      generator)
        pos = _position_feat(self.position_encoder, ref_c, query.dtype)
        return out + residual + pos, torch.zeros((), device=query.device)


class Detr3DCrossAttenV2(nn.Module):
    def __init__(self, embed_dims=256, num_heads=8, num_levels=4, num_points=4,
                 num_cams=6, pc_range: Tuple[float, ...] = PC_RANGE,
                 dropout=0.1):
        super().__init__()
        C = embed_dims
        self.dropout = dropout
        self.num_heads, self.num_levels = num_heads, num_levels
        self.num_points, self.num_cams = num_points, num_cams
        self.pc_range = tuple(pc_range)
        self.cam_shard = None  # a Mesh with a cam group, or None
        n = num_cams * num_heads * num_levels * num_points
        self.attention_weights = Linear(C, n)
        self.sampling_offsets = Linear(C, 2 * n)
        self.output_proj = Linear(C, C)
        self.position_encoder = ln_mlp(3, C)

    def forward(self, query, value, spatial_shapes: Sequence[Tuple[int, int]],
                query_pos, reference_points, lidar2img, img_shape,
                generator=None):
        B, Q, C = query.shape
        N, nh, L, P = (self.num_cams, self.num_heads, self.num_levels,
                       self.num_points)
        n = lidar2img.shape[1]  # the cameras this rank holds
        cams = camera_slice(self.cam_shard, n)
        residual = query
        q = query + query_pos
        attn = torch.softmax(
            self.attention_weights(q).float().view(B, Q, N, nh, L * P)[:, :, cams],
            dim=-1).view(B, Q, n, nh, L, P)
        offsets = self.sampling_offsets(q).view(
            B, Q, N, nh, L, P, 2)[:, :, cams].float()
        centre, mask = project_to_cams(
            denormalize_points(reference_points.float(), self.pc_range),
            lidar2img, img_shape)
        centre = centre.transpose(1, 2)  # (B, Q, N, 2)
        attn = attn * mask.transpose(1, 2)[..., None, None, None]
        # the reference's [-1, 1]-space offset / (W_l, H_l) (:699-702) is
        # offset / (2 W_l, 2 H_l) in [0, 1]
        norm = torch.tensor([[2.0 * w, 2.0 * h] for h, w in spatial_shapes],
                            device=query.device)
        loc = centre[:, :, :, None, None, None, :] + offsets / norm[:, None, :]
        loc = loc.permute(0, 2, 1, 3, 4, 5, 6).reshape(B * n, Q, nh, L, P, 2)
        attn = attn.permute(0, 2, 1, 3, 4, 5).reshape(B * n, Q, nh, L, P)
        sampled = msda_ops.msda_forward(
            value.reshape(B * n, -1, nh, C // nh), spatial_shapes,
            loc.contiguous(), attn.contiguous())
        out = sum_cameras(sampled.view(B, n, Q, C).float(), self.cam_shard)
        out = dropout(self.output_proj(out.to(query.dtype)), self.dropout,
                      generator)
        pos = _position_feat(self.position_encoder, reference_points, query.dtype)
        return out + residual + pos, torch.zeros((), device=query.device)
