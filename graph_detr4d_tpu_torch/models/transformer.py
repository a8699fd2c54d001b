"""DETR3D decoder layer (counterpart of graph_detr4d_tpu/models/transformer.py).

mmcv DetrTransformerDecoderLayer with operation order (self_attn, norm,
cross_attn, norm, ffn, norm), post-norm (configs/detr4d/...12e.py:83-84).
Dropout sits where the JAX layer has it: the self-attention weights (flax
MultiHeadDotProductAttention's `dropout_rate`, one mask broadcast over
batch and heads), the self-attention output (transformer.py:82), the
cross-attention output (attention.py:283) and both FFN layers (:37, :39).
It is drawn from the `generator` a forward is given; without one (eval)
it is the identity. Module names follow the reference's state_dict
(`attentions.0.attn.in_proj_weight`, `ffns.0`, `norms.2`, ...).
"""

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .attention import Deform3DCrossAttn
from .attention_variants import (Deform3DCrossAttnMP, Detr3DCrossAtten,
                                 Detr3DCrossAttenV2)
from ..parallel.mesh import all_reduce_max, all_reduce_sum
from .layers import LayerNorm, Linear, dropout

ATTN_TYPES = ("deform3d", "deform3d_mp", "detr3d", "detr3d_v2")


def graph_neighbours(ref: torch.Tensor, k: int) -> torch.Tensor:
    """The MP query graph: each query's k nearest other queries by squared
    distance between reference points (self excluded by +1e9), (B, Q, k)
    indices, nearest first. The JAX decoder's top_k of the negated
    distances (transformer.py:123-132); the two may order exact ties
    differently, which changes only the order of a sum over neighbours."""
    d2 = ((ref[:, :, None, :] - ref[:, None, :, :]) ** 2).sum(-1)
    eye = torch.eye(ref.shape[1], dtype=d2.dtype, device=d2.device)
    return torch.topk(-(d2 + eye * 1e9), k, dim=-1).indices


def graph_reference_points(ref: torch.Tensor, k: int) -> torch.Tensor:
    """(B, Q * (1 + k), 3): the queries' reference points, then their k
    graph neighbours' (`graph_neighbours`), neighbour-major (j * Q + q)."""
    B, Q, _ = ref.shape
    idx = graph_neighbours(ref, k)
    nbrs = ref[torch.arange(B, device=ref.device)[:, None, None], idx]
    return torch.cat([ref, nbrs.transpose(1, 2).reshape(B, k * Q, 3)], dim=1)


class MultiheadAttention(nn.Module):
    """Batch-first multi-head attention with nn.MultiheadAttention's
    parameters (packed in_proj, out_proj), as plain matmuls and a softmax
    in fp32. An optional bool mask (True = attend; flax
    MultiHeadDotProductAttention's `mask`) that broadcasts to the logits
    (B, heads, Q, T): a (Q, T) query-key mask, or a (B, 1, 1, T) key mask
    (the PETR heads' padded pixels). It fills the logits it leaves out
    with -inf before the softmax: every row attends to some key, so those
    weights are exact zeros, as flax's finfo.min fill gives.

    `shard` (a parallel/mesh.py Mesh with a cam group; PETR's dense
    cross-attention under models/detector.py::shard_cameras): the rank
    holds keys [cam_index * T, (cam_index + 1) * T) of the rig's cam * T,
    camera-major, and the softmax over all keys is merged across the
    group: m = the group's row max (detached: the softmax does not depend
    on it), den = the group's sum of exp(l - m), this rank's weights
    exp(l - m) / den, and the group's sum of their products with its
    values. A rank whose keys are all masked contributes zeros. Dropout
    draws the whole (Q, cam * T) mask from the generator, equal across
    the group, and keeps this rank's columns: one process draws the same
    bits. The merge sums in another order than one softmax, a rounding
    difference only."""

    def __init__(self, embed_dims: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dims, embed_dims))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dims))
        self.out_proj = Linear(embed_dims, embed_dims)

    def forward(self, query, key, value, generator=None, mask=None,
                shard=None):
        B, Q, C = query.shape
        h = self.num_heads
        w = self.in_proj_weight.to(query.dtype)
        b = self.in_proj_bias.to(query.dtype)

        def heads(x, i):
            y = F.linear(x, w[i * C:(i + 1) * C], b[i * C:(i + 1) * C])
            return y.view(B, -1, h, C // h).transpose(1, 2)  # (B, h, T, hd)

        q = heads(query, 0) / (C // h) ** 0.5
        k, v = heads(key, 1), heads(value, 2)
        logits = (q @ k.transpose(-1, -2)).float()
        if mask is not None:
            logits = logits.masked_fill(~mask, float("-inf"))
        if shard is None:
            weights = torch.softmax(logits, dim=-1)
            weights = dropout(weights, self.dropout, generator,
                              shape=weights.shape[-2:])
            out = weights.to(v.dtype) @ v
        else:
            group, T = shard.cam_group, logits.shape[-1]
            m = all_reduce_max(logits.amax(dim=-1, keepdim=True), group)
            e = torch.exp(logits - m)
            weights = e / all_reduce_sum(e.sum(dim=-1, keepdim=True), group)
            if generator is not None and self.dropout > 0.0:
                first = shard.cam_index * T
                keep = torch.rand((Q, T * shard.cam), generator=generator,
                                  device=weights.device)[:, first:first + T]
                weights = torch.where(keep < 1.0 - self.dropout,
                                      weights / (1.0 - self.dropout), 0.0)
            out = all_reduce_sum((weights.to(v.dtype) @ v).float(), group)
            out = out.to(v.dtype)
        out = out.transpose(1, 2).reshape(B, Q, C)
        return self.out_proj(out)


class SelfAttention(nn.Module):
    """mmcv MultiheadAttention wrapper: q = k = query + pos, v = query,
    out = query + attn."""

    def __init__(self, embed_dims: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.attn = MultiheadAttention(embed_dims, num_heads, dropout)

    def forward(self, query, query_pos, generator=None, mask=None):
        q = query + query_pos
        out = self.attn(q, q, query, generator, mask)
        return query + dropout(out, self.dropout, generator)


class FFN(nn.Module):
    def __init__(self, embed_dims: int, hidden: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.layers = nn.ModuleList([
            nn.Sequential(Linear(embed_dims, hidden), nn.ReLU()),
            Linear(hidden, embed_dims),
        ])

    def forward(self, x, generator=None):
        y = dropout(self.layers[0](x), self.dropout, generator)
        return x + dropout(self.layers[1](y), self.dropout, generator)


class DecoderLayer(nn.Module):
    def __init__(
        self,
        embed_dims: int,
        num_heads: int,
        num_levels: int,
        num_points: int,
        num_cams: int,
        ffn_dims: int,
        pc_range: Tuple[float, ...],
        cam_capacity: float = 1.0,
        dropout: float = 0.1,
        attn_type: str = "deform3d",
        num_neighbors: int = 8,
        depth_encode: bool = False,
        fix_offset: bool = False,
    ):
        super().__init__()
        if attn_type not in ATTN_TYPES:
            raise ValueError(f"unknown attn_type {attn_type!r}")
        self.attn_type, self.num_neighbors = attn_type, num_neighbors
        common = dict(embed_dims=embed_dims, num_levels=num_levels,
                      num_cams=num_cams, pc_range=pc_range, dropout=dropout)
        if attn_type == "deform3d":
            cross = Deform3DCrossAttn(num_heads=num_heads, num_points=num_points,
                                      cam_capacity=cam_capacity,
                                      depth_encode=depth_encode,
                                      fix_offset=fix_offset, **common)
        elif attn_type == "deform3d_mp":
            cross = Deform3DCrossAttnMP(num_heads=num_heads,
                                        num_points=num_points,
                                        num_neighbors=num_neighbors, **common)
        elif attn_type == "detr3d":
            cross = Detr3DCrossAtten(num_points=1, **common)
        else:
            cross = Detr3DCrossAttenV2(num_heads=num_heads,
                                       num_points=num_points, **common)
        self.attentions = nn.ModuleList([
            SelfAttention(embed_dims, num_heads, dropout), cross])
        self.ffns = nn.ModuleList([FFN(embed_dims, ffn_dims, dropout)])
        self.norms = nn.ModuleList([LayerNorm(embed_dims) for _ in range(3)])

    def forward(
        self,
        query: torch.Tensor,
        query_pos: torch.Tensor,
        value: torch.Tensor,
        spatial_shapes: Sequence[Tuple[int, int]],
        reference_points: torch.Tensor,
        lidar2img: torch.Tensor,
        img_shape: Tuple[int, int],
        generator=None,
        self_attn_mask=None,
    ):
        """Returns (query, cam_overflow) (see Deform3DCrossAttn; the other
        cross-attentions compact nothing and report 0). Dropout draws from
        `generator`; None (eval) turns it off. self_attn_mask: (Q, Q) bool,
        True = attend (H-DETR's group mask), or None."""
        query = self.norms[0](self.attentions[0](query, query_pos, generator,
                                                 self_attn_mask))
        if self.attn_type == "deform3d_mp":
            reference_points = graph_reference_points(reference_points,
                                                       self.num_neighbors)
        query, overflow = self.attentions[1](
            query, value, spatial_shapes, query_pos, reference_points,
            lidar2img, img_shape, generator,
        )
        query = self.norms[1](query)
        query = self.norms[2](self.ffns[0](query, generator))
        return query, overflow
