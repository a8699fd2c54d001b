"""PETR / PETRv2 heads: dense-attention multi-view 3D detection
(counterpart of graph_detr4d_tpu/models/petr_head.py; reference:
models/dense_heads/petr_head.py:44-733, petrv2_head.py:91-815).

  * one feature level (level 0), projected by a 1x1 `input_proj`; a
    per-pixel 3D coordinate embedding over LID or linear depth bins,
    normalised by `petr_position_range` (not pc_range), MLP-encoded, in
    PETRv2 gated by an SE layer of the projected features (`fpe`); plus
    the 3-axis sine PE with offset 0 (the flagship uses -0.5);
  * queries from a learned (num_query, 3) table of reference points in
    [0, 1), embedded by the interleaved sine `pos2posemb3d` and a small
    MLP; the query content starts at zero;
  * an encoder-free decoder whose cross-attention is dense: every query
    attends to every pixel of every camera, (B, N*H*W, C) keys. It is
    plain PyTorch (models/transformer.py::MultiheadAttention: fp32 logits
    and softmax), as the JAX package computes it with XLA einsums and no
    kernel;
  * the decoder's `post_norm` applies to every layer's output before the
    branches and is not fed back (petr_transformer.py:443-445): the
    branches see each layer's output LayerNorm'd twice;
  * decode adds the reg deltas to the reference points in inverse-sigmoid
    space, without iterative refinement, and denormalises with pc_range
    (petr_head.py:436-442); PETRv2 (`with_time`) divides the velocity by
    `mean_time_stamp` when the caller gives it (petrv2_head.py:488-510).

PETRv1 shares one cls and one reg branch across the layers
(petr_head.py:240-243): `cls_branches` holds the same module at every
index, so state_dict() writes every index (as the reference's checkpoint
holds them) and parameters() yields each tensor once. A reference dict
whose indices differ loads with the last index winning, as each index
loads in turn into the shared module (the JAX converter instead tells a
shared from a per-layer dict by value equality and keeps index 0).
PETRv2 holds a branch per layer, its reg branch the grouped `RegLayer`.

The dense heads have no per-camera compaction: `cam_overflow` is 0.
Public tensors keep the JAX layouts: features L x (B, N, H, W, C),
outputs (layers, B, Q, .).
"""

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn

from ..config import HeadConfig
from ..utils.math import inverse_sigmoid
from .head import Decoder, cls_branch, reg_branch
from .layers import LayerNorm, Linear, PointwiseConv, SELayer, dropout, two_layer_mlp
from .positional import (coords_position_3d, lid_depth_bins,
                         sine_positional_encoding_3d)
from .transformer import FFN, MultiheadAttention, SelfAttention


def sine_embed(pos: torch.Tensor, axes, num_pos_feats: int = 128,
               temperature: float = 10000.0) -> torch.Tensor:
    """Sine embedding of normalised positions (..., D): the given axes in
    order, each (..., num_pos_feats) interleaved [sin(p0), cos(p1),
    sin(p2), ...] (unlike the 3D PE's block layout), concatenated."""
    pos = pos * (2 * math.pi)
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)

    def enc(p):
        p = p[..., None] / dim_t
        return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()],
                           dim=-1).flatten(-2)

    return torch.cat([enc(pos[..., i]) for i in axes], dim=-1)


def pos2posemb3d(pos: torch.Tensor, num_pos_feats: int = 128,
                 temperature: float = 10000.0) -> torch.Tensor:
    """(..., 3) -> (..., 3 * num_pos_feats) as [x, y, z]
    (petr_head.py:29-42)."""
    return sine_embed(pos, (0, 1, 2), num_pos_feats, temperature)


def depth_bins(cfg: HeadConfig, device=None) -> torch.Tensor:
    """The PETR heads' D depth bin centres, ending at the position range's
    x1 (petr_head.py:207-209): LID, or linear from depth_start."""
    D, start, stop = cfg.depth_num, cfg.depth_start, cfg.petr_position_range[3]
    if cfg.petr_lid:
        return lid_depth_bins(D, start, stop, device=device)
    return start + (stop - start) / D * torch.arange(
        D, dtype=torch.float32, device=device)


class CrossAttention(nn.Module):
    """mmcv MultiheadAttention as PETR's dense cross-attention: q = query +
    query_pos, k = memory + key_pos, v = memory, out = query +
    dropout(attn)."""

    def __init__(self, embed_dims: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.attn = MultiheadAttention(embed_dims, num_heads, dropout)

    def forward(self, query, query_pos, memory, key_pos, generator=None,
                mask=None):
        out = self.attn(query + query_pos, memory + key_pos, memory,
                        generator, mask)
        return query + dropout(out, self.dropout, generator)


class PETRDecoderLayer(nn.Module):
    """Post-norm PETR decoder layer (petr_transformer.py:114-185):
    self-attention, norm, dense cross-attention, norm, FFN, norm, with
    dropout where flax has it. Names follow the reference's state_dict
    (`attentions.{0,1}.attn`, `ffns.0.layers`, `norms.{0,1,2}`)."""

    def __init__(self, embed_dims: int, num_heads: int, ffn_dims: int,
                 dropout: float = 0.1):
        super().__init__()
        self.attentions = nn.ModuleList([
            SelfAttention(embed_dims, num_heads, dropout),
            CrossAttention(embed_dims, num_heads, dropout)])
        self.ffns = nn.ModuleList([FFN(embed_dims, ffn_dims, dropout)])
        self.norms = nn.ModuleList([LayerNorm(embed_dims) for _ in range(3)])

    def forward(self, query, query_pos, memory, key_pos, generator=None,
                key_mask=None):
        """key_mask: (B, 1, 1, K) bool, False = a padded pixel, or None."""
        query = self.norms[0](self.attentions[0](query, query_pos, generator))
        query = self.norms[1](self.attentions[1](
            query, query_pos, memory, key_pos, generator, key_mask))
        return self.norms[2](self.ffns[0](query, generator))


class RegLayer(nn.Module):
    """PETRv2's grouped reg branch (petrv2_head.py:58-88): a num_fcs-deep
    Linear + ReLU trunk (`reg_branch`, Linears at 0, 3, ...: the
    reference's Dropout(0.0) sits at 2, 5, ..., an identity here), then one
    Linear-ReLU-Linear head per group of code dims (`task_heads`),
    concatenated in group order."""

    def __init__(self, embed_dims: int, groups: Tuple[int, ...] = (2, 1, 3, 2, 2),
                 num_fcs: int = 2):
        super().__init__()
        C = embed_dims
        trunk = []
        for _ in range(num_fcs):
            trunk += [Linear(C, C), nn.ReLU(), nn.Identity()]
        self.reg_branch = nn.Sequential(*trunk)
        self.task_heads = nn.ModuleList(
            nn.Sequential(Linear(C, C), nn.ReLU(), Linear(C, g))
            for g in groups)

    def forward(self, x):
        x = self.reg_branch(x)
        return torch.cat([h(x) for h in self.task_heads], dim=-1)


def petr_transformer(cfg: HeadConfig) -> nn.Module:
    """A PETRTransformer's decoder under the reference's names
    (`decoder.layers.{l}`, `decoder.post_norm`)."""
    decoder = Decoder([
        PETRDecoderLayer(cfg.embed_dims, cfg.num_heads, cfg.ffn_dims,
                         cfg.dropout)
        for _ in range(cfg.num_decoder_layers)])
    decoder.post_norm = LayerNorm(cfg.embed_dims)
    transformer = nn.Module()
    transformer.decoder = decoder
    return transformer


def shared_or_per_layer(make, layers: int, per_layer: bool) -> nn.ModuleList:
    """`layers` modules from `make`: one each, or one shared module at every
    index."""
    if per_layer:
        return nn.ModuleList(make() for _ in range(layers))
    return nn.ModuleList([make()] * layers)


class PETRHead(nn.Module):
    """PETR (v1) and PETRv2 (`with_time`, `with_fpe`, `with_multi`,
    `per_layer_branches`, as models/detector.py sets them). in_channels:
    the channels of the level-0 features (the neck's, or C5's without a
    neck)."""

    GATE = "fpe"  # the SE gate's name on the coordinate PE

    def __init__(self, cfg: HeadConfig, img_shape: Tuple[int, int],
                 in_channels: int, with_time: bool = False,
                 with_fpe: bool = False, with_multi: bool = False,
                 per_layer_branches: bool = False):
        super().__init__()
        self.cfg = cfg
        self.img_shape = tuple(img_shape)
        self.with_time = with_time
        C, L = cfg.embed_dims, cfg.num_decoder_layers
        self.input_proj = PointwiseConv(in_channels, C)
        self.position_encoder = two_layer_mlp(cfg.depth_num * 3, 4 * C, C)
        self.adapt_pos3d = two_layer_mlp(cfg.pe_num_feats * 3, 4 * C, C)
        if with_fpe:
            self.add_module(self.GATE, SELayer(C))
        self.reference_points = nn.Embedding(cfg.num_query, 3)
        self.query_embedding = nn.Sequential(
            Linear(cfg.pe_num_feats * 3, C), nn.ReLU(), Linear(C, C))
        self.transformer = petr_transformer(cfg)
        self.cls_branches = shared_or_per_layer(
            lambda: cls_branch(C, cfg.num_classes, cfg.num_reg_fcs), L,
            per_layer_branches)
        self.reg_branches = shared_or_per_layer(
            (lambda: RegLayer(C, num_fcs=cfg.num_reg_fcs)) if with_multi else
            (lambda: reg_branch(C, cfg.code_size, cfg.num_reg_fcs)), L,
            per_layer_branches)

    def padding_mask(self, B, N, H, W, img_valid_hw, device):
        """The sine PE's (B, N, H, W) padding mask (1 = padded) and the
        cross-attention's (B, 1, 1, N*H*W) key mask (True = attend; None
        without img_valid_hw). With img_valid_hw (B, N, 2), each camera's
        valid (img_h, img_w) in padded-image pixels, feature cell (y, x)
        is valid iff floor(y * pad_h / H) < img_h and floor(x * pad_w / W)
        < img_w: the reference's mask of the pad canvas, nearest-resized
        to the feature grid (petr_head.py:377-387)."""
        if img_valid_hw is None:
            return torch.zeros(B, N, H, W, device=device), None
        pad_h, pad_w = self.img_shape
        ys = torch.floor(torch.arange(H, dtype=torch.float32, device=device)
                         * pad_h / H)
        xs = torch.floor(torch.arange(W, dtype=torch.float32, device=device)
                         * pad_w / W)
        hw = img_valid_hw.float()
        valid = ((ys[None, None, :] < hw[..., 0:1])[..., :, None]
                 & (xs[None, None, :] < hw[..., 1:2])[..., None, :])
        return 1.0 - valid.float(), valid.reshape(B, 1, 1, N * H * W)

    def memory(self, feat, lidar2img, img_valid_hw=None):
        """(memory (B, K, C), key_pos (B, K, C), key_mask) of level-0
        features (B, N, H, W, Cin) in the compute dtype, K = N*H*W."""
        cfg = self.cfg
        B, N, H, W, _ = feat.shape
        dtype, dev = feat.dtype, feat.device
        x = self.input_proj(feat)
        p3d = coords_position_3d(lidar2img, H, W, self.img_shape,
                                 depth_bins(cfg, dev), cfg.petr_position_range)
        pos3d = self.position_encoder(p3d.to(dtype))
        gate = getattr(self, self.GATE, None)
        if gate is not None:
            pos3d = gate(pos3d, x)
        mask, key_mask = self.padding_mask(B, N, H, W, img_valid_hw, dev)
        sin = sine_positional_encoding_3d(mask, num_feats=cfg.pe_num_feats,
                                          offset=0.0)
        key_pos = pos3d + self.adapt_pos3d(sin.to(dtype))
        return (x.reshape(B, N * H * W, -1), key_pos.reshape(B, N * H * W, -1),
                key_mask)

    def queries(self, B, dtype):
        """(zero query (B, Q, C), query_pos (B, Q, C), inverse-sigmoid
        reference points (Q, 3) fp32)."""
        ref = self.reference_points.weight.float()
        query_pos = self.query_embedding(
            pos2posemb3d(ref, self.cfg.pe_num_feats).to(dtype))
        query_pos = query_pos[None].expand(B, -1, -1)
        return torch.zeros_like(query_pos), query_pos, inverse_sigmoid(ref)

    def decode_boxes(self, tmp, ref_is, mean_time_stamp):
        """Reg deltas (B, Q, code) fp32 -> boxes: xy and z from the
        reference point in inverse-sigmoid space, denormalised by
        pc_range; with_time divides the velocity by mean_time_stamp."""
        pc = self.cfg.pc_range
        xy = torch.sigmoid(tmp[..., 0:2] + ref_is[..., 0:2])
        z = torch.sigmoid(tmp[..., 4:5] + ref_is[..., 2:3])
        cx = xy[..., 0:1] * (pc[3] - pc[0]) + pc[0]
        cy = xy[..., 1:2] * (pc[4] - pc[1]) + pc[1]
        cz = z * (pc[5] - pc[2]) + pc[2]
        vel = tmp[..., 8:10]
        if self.with_time and mean_time_stamp is not None:
            vel = vel / mean_time_stamp.float()[:, None, None]
        return torch.cat([cx, cy, tmp[..., 2:4], cz, tmp[..., 5:8], vel], -1)

    def forward(self, mlvl_feats: Sequence[torch.Tensor], lidar2img,
                generator=None, mean_time_stamp=None, img_valid_hw=None):
        """mlvl_feats: L x (B, N, H, W, Cin) in the compute dtype (level 0 is
        read); lidar2img (B, N, 4, 4); generator: dropout's random source
        in training, None in eval; mean_time_stamp (B,) seconds (PETRv2);
        img_valid_hw (B, N, 2) for inputs whose true image is smaller than
        the padded canvas, None for every shipped config. Returns
        {'all_cls_scores' (layers, B, Q, classes), 'all_bbox_preds'
        (layers, B, Q, code), 'cam_overflow' 0}."""
        memory, key_pos, key_mask = self.memory(mlvl_feats[0], lidar2img,
                                                img_valid_hw)
        query, query_pos, ref_is = self.queries(memory.shape[0], memory.dtype)
        decoder = self.transformer.decoder
        cls_scores, bbox_preds = [], []
        for lid, layer in enumerate(decoder.layers):
            query = layer(query, query_pos, memory, key_pos, generator,
                          key_mask)
            inter = decoder.post_norm(query)
            cls_scores.append(self.cls_branches[lid](inter).float())
            bbox_preds.append(self.decode_boxes(
                self.reg_branches[lid](inter).float(), ref_is,
                mean_time_stamp))
        # no per-camera compaction in a dense head: nothing overflows
        return {"all_cls_scores": torch.stack(cls_scores),
                "all_bbox_preds": torch.stack(bbox_preds),
                "cam_overflow": torch.zeros((), device=memory.device)}
