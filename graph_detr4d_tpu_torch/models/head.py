"""Detr3DHeadPE, the Graph-DETR4D detection head (counterpart of
graph_detr4d_tpu/models/head.py; reference:
projects/mmdet3d_plugin/models/dense_heads/detr3d_head_pe.py):

  * PETR-style 3D position embedding: LID depth bins back-projected
    through img2lidar, MLP-encoded, gated by an SE layer (`fpe`), plus a
    3-axis sine PE (:427-491, :541-553);
  * learned queries -> decoder with iterative box refinement; untied
    per-layer cls/reg branches (:406-408);
  * decode: xy / z offsets added in inverse-sigmoid space to the
    reference point ENTERING the layer, then sigmoid and pc_range denorm
    (:587-600).

With `with_detach`, level 0 of the past frame's cameras is cut from the
gradient (:512-516); a camera shard (`cam_shard`) cuts the ones of its
cameras that are past-frame cameras of the whole rig. Public tensors
keep the JAX layouts: features L x (B, N, H, W, C), outputs (layers, B,
Q, .).

Options of the head family:
  * H-DETR hybrid matching (`num_query_one2many` > 0,
    h_detr3d_head_pe.py:300-304, 361-364): a second query group of
    num_query_one2many rows, isolated from the one2one group by a
    block-diagonal self-attention mask, decoded with it and returned as
    the `_one2many` twins of the outputs. As the JAX head, eval runs both
    groups (the one2one outputs are the same either way).
  * camera-aware (`cam_aware`, Detr3DHeadPECAM): one DepthNet modulates
    every level by each camera's intrinsics and augmentation scale;
    `fpe_type='camconv'` swaps the SE gate on the PE for SELayerCAMConv.
  * `scale_pred`: the decoded centres are multiplied by `depth_factors`
    (:592-595) when the caller passes them.
  * MixDistill (`teacher_query_embed`, mix_distill.py:102,
    detr3d_head_pe.py:617-671): a second pass of the whole decoder over the
    teacher's (Qt, 2C) query table, detached, with no self-attention mask,
    sharing the student's layers, branches and reference-point
    projection; returned as `all_cls_scores_guided` /
    `all_bbox_preds_guided` with its own `cam_overflow_guided`.

The forward is written once, as `steps`, a generator that yields each
decoder layer's K1 calls and eager stretches (models/k1_graph.py): every
cross-attention is a `steps` generator itself, and K1 is launched only
by what drives it. An eval forward on the card without autograd, a
generator, a camera shard or MixDistill's pass, with every layer's
cross-attention deform3d (the flagship's, with any of the options
above) or MP's, replays it as CUDA graphs between its K1 calls and
eager stretches, K1 still launched and MP's query graph and span
stretches still run eagerly: the first call of an input signature (B,
N, the level shapes, the dtype, which extras are given) runs eagerly,
the second captures, later calls replay. A replayed call copies its
inputs into the graphs' own and keeps none of them; every tensor it
returns, `cam_overflow` included, is fresh and is not written again.
The DETR3D and DETR3D-v2 cross-attentions, training, camera shards and
MixDistill run eagerly.
"""

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from ..config import HeadConfig
from ..utils.math import inverse_sigmoid
from .camera_aware import DepthNet, SELayerCAMConv
from .k1_graph import K1Graphs, run_k1
from .layers import LayerNorm, Linear, SELayer, two_layer_mlp
from .positional import (coords_position_3d, lid_depth_bins,
                         sine_positional_encoding_3d)
from .transformer import DecoderLayer


def rig_cameras(shard, n: int, num_cams: int):
    """(the rig's camera count, the first of the n cameras this rank
    holds): (n, 0) without a camera shard (models/detector.py::
    shard_cameras), which must hold num_cams / cam of them."""
    if shard is None:
        return n, 0
    if n * shard.cam != num_cams:
        raise ValueError(f"a camera shard of {shard.cam} takes "
                         f"{num_cams // shard.cam} cameras, got {n}: "
                         "pass parallel/mesh.py::shard_batch's slice")
    return n * shard.cam, shard.cam_index * n


def cls_branch(embed_dims: int, num_classes: int, num_fcs: int = 2):
    layers = []
    for _ in range(num_fcs):
        layers += [Linear(embed_dims, embed_dims), LayerNorm(embed_dims),
                   nn.ReLU()]
    layers.append(Linear(embed_dims, num_classes))
    return nn.Sequential(*layers)


def reg_branch(embed_dims: int, code_size: int, num_fcs: int = 2):
    layers = []
    for _ in range(num_fcs):
        layers += [Linear(embed_dims, embed_dims), nn.ReLU()]
    layers.append(Linear(embed_dims, code_size))
    return nn.Sequential(*layers)


class Decoder(nn.Module):
    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class Transformer(nn.Module):
    """Holds the reference-point projection and the decoder layers under
    the reference's names (`transformer.reference_points`,
    `transformer.decoder.layers.{i}`); the loop itself is in the head."""

    def __init__(self, cfg: HeadConfig):
        super().__init__()
        self.reference_points = Linear(cfg.embed_dims, 3)
        self.decoder = Decoder([
            DecoderLayer(
                embed_dims=cfg.embed_dims,
                num_heads=cfg.num_heads,
                num_levels=cfg.num_levels,
                num_points=cfg.num_points,
                num_cams=cfg.num_cams,
                ffn_dims=cfg.ffn_dims,
                pc_range=cfg.pc_range,
                cam_capacity=cfg.cam_capacity,
                dropout=cfg.dropout,
                attn_type=cfg.attn_type,
                num_neighbors=cfg.num_neighbors,
                depth_encode=cfg.depth_encode,
                fix_offset=cfg.fix_offset,
            )
            for _ in range(cfg.num_decoder_layers)
        ])


class Detr3DHeadPE(nn.Module):
    def __init__(self, cfg: HeadConfig, img_shape: Tuple[int, int]):
        super().__init__()
        self.cfg = cfg
        self.img_shape = tuple(img_shape)
        self.cam_shard = None  # a Mesh with a cam group, or None
        self.graphs = K1Graphs()  # the eval forward's CUDA graphs
        C = cfg.embed_dims
        self.query_embedding = nn.Embedding(
            cfg.num_query + cfg.num_query_one2many, 2 * C)
        self.transformer = Transformer(cfg)
        if cfg.cam_aware:
            self.depth_net = DepthNet(C, C)
        if cfg.with_pe:  # the plain Detr3DHead (with_pe False) has none
            self.position_encoder = two_layer_mlp(cfg.depth_num * 3, 4 * C, C)
            self.adapt_pos3d = two_layer_mlp(cfg.pe_num_feats * 3, 4 * C, C)
            if cfg.with_fpe:
                self.fpe = (SELayerCAMConv(C, self.img_shape)
                            if cfg.fpe_type == "camconv" else SELayer(C))
        self.cls_branches = nn.ModuleList(
            cls_branch(C, cfg.num_classes, cfg.num_reg_fcs)
            for _ in range(cfg.num_decoder_layers)
        )
        self.reg_branches = nn.ModuleList(
            reg_branch(C, cfg.code_size, cfg.num_reg_fcs)
            for _ in range(cfg.num_decoder_layers)
        )

    def position_embedding(self, feat, lidar2img):
        """LID-bin 3D position embedding of one level (:427-491), fp32:
        (B, N, H, W, C) features -> (B, N, H, W, depth_num * 3)."""
        cfg = self.cfg
        _, _, H, W, _ = feat.shape
        d = lid_depth_bins(cfg.depth_num, cfg.depth_start, cfg.pc_range[3],
                           device=feat.device)
        return coords_position_3d(lidar2img, H, W, self.img_shape, d,
                                  cfg.pc_range)

    def self_attn_mask(self, device):
        """H-DETR's (Q, Q) block-diagonal group mask, True = attend; None
        without a one2many group."""
        cfg = self.cfg
        if cfg.num_query_one2many <= 0:
            return None
        g = torch.arange(cfg.num_query + cfg.num_query_one2many,
                         device=device) >= cfg.num_query
        return g[:, None] == g[None, :]

    def decode_steps(self, query_embed, value, shapes, lidar2img, generator,
                     attn_mask, df):
        """The decoder stack with iterative box refinement on a (Qx, 2C)
        query table, as a generator of its layers' K1 calls
        (models/k1_graph.py): returns (cls (layers, B, Qx, classes), boxes
        (layers, B, Qx, code), cam_overflow)."""
        cfg = self.cfg
        B, dtype = value.shape[0], value.dtype
        query_pos, query = query_embed.split(cfg.embed_dims, dim=1)
        query_pos = query_pos[None].to(dtype).expand(B, -1, -1)
        query = query[None].to(dtype).expand(B, -1, -1)
        reference_points = torch.sigmoid(
            self.transformer.reference_points(query_pos.float())
        )

        pc = cfg.pc_range
        cls_scores, bbox_preds, overflow = [], [], 0.0
        for lid, layer in enumerate(self.transformer.decoder.layers):
            query, ov = yield from layer.steps(
                query, query_pos, value, shapes, reference_points, lidar2img,
                self.img_shape, generator, attn_mask)
            overflow = overflow + ov
            score = self.cls_branches[lid](query)
            tmp = self.reg_branches[lid](query).float()

            ref = inverse_sigmoid(reference_points)
            xy = torch.sigmoid(tmp[..., 0:2] + ref[..., 0:2])
            z = torch.sigmoid(tmp[..., 4:5] + ref[..., 2:3])
            cx = xy[..., 0:1] * (pc[3] - pc[0]) + pc[0]
            cy = xy[..., 1:2] * (pc[4] - pc[1]) + pc[1]
            cz = z * (pc[5] - pc[2]) + pc[2]
            if df is not None:
                cx, cy, cz = cx * df, cy * df, cz * df
            bbox_preds.append(
                torch.cat([cx, cy, tmp[..., 2:4], cz, tmp[..., 5:]], dim=-1)
            )
            cls_scores.append(score.float())
            # iterative refinement (detr3d_transformer.py:201-214)
            reference_points = torch.cat([xy, z], dim=-1).detach()
        return torch.stack(cls_scores), torch.stack(bbox_preds), overflow

    def forward(self, mlvl_feats, lidar2img, generator=None,
                depth_factors=None, intrinsics=None, ida_scale=None,
                teacher_query_embed=None):
        """mlvl_feats: L x (B, N, H, W, C) in the compute dtype;
        lidar2img (B, N, 4, 4); generator: dropout's random source in
        training, None in eval; depth_factors (B,) for scale_pred;
        intrinsics (B, N, 4, 4) and ida_scale (B, N) for the camera-aware
        head (absent: the identity and ones, as the JAX head);
        teacher_query_embed: MixDistill's (Qt, 2C) teacher query table, or
        None. Returns {'all_cls_scores' (layers, B, Q, classes),
        'all_bbox_preds' (layers, B, Q, code), 'cam_overflow'}, with a
        one2many group 'all_cls_scores_one2many' /
        'all_bbox_preds_one2many', and with teacher_query_embed
        'all_cls_scores_guided' / 'all_bbox_preds_guided' (layers, B, Qt,
        .) and 'cam_overflow_guided'. Eagerly or as CUDA graphs
        (`self.graphs`, models/k1_graph.py::K1Graphs), as the module's
        docstring says; `graphed` decides.
        """
        mlvl_feats = list(mlvl_feats)
        if self.graphed(mlvl_feats[0], generator, teacher_query_embed):
            L = len(mlvl_feats)
            return self.graphs(
                lambda *t: self.steps(list(t[:L]), *t[L:]),
                [*mlvl_feats, lidar2img, depth_factors, intrinsics, ida_scale])
        return run_k1(self.steps(mlvl_feats, lidar2img, depth_factors,
                                 intrinsics, ida_scale, generator,
                                 teacher_query_embed))

    def graphed(self, feat, generator, teacher_query_embed) -> bool:
        """Whether forward replays CUDA graphs (see forward)."""
        return (feat.is_cuda and not self.training
                and not torch.is_grad_enabled() and generator is None
                and teacher_query_embed is None and self.cam_shard is None
                and all(layer.attn_type in ("deform3d", "deform3d_mp")
                        and layer.attentions[1].cam_shard is None
                        for layer in self.transformer.decoder.layers))

    def steps(self, mlvl_feats, lidar2img, depth_factors=None,
              intrinsics=None, ida_scale=None, generator=None,
              teacher_query_embed=None):
        """forward as a generator of its K1 calls (models/k1_graph.py)."""
        cfg = self.cfg
        dtype = mlvl_feats[0].dtype
        B, N = mlvl_feats[0].shape[:2]
        dev = mlvl_feats[0].device
        lidar2img = lidar2img.float()
        if cfg.cam_aware:
            # detr3d_head_pe_camaware.py:315-319, every level
            if intrinsics is None:
                intrinsics = torch.eye(4, device=dev).expand(B, N, 4, 4)
            if ida_scale is None:
                ida_scale = torch.ones(B, N, device=dev)
            mlvl_feats = [self.depth_net(f, intrinsics, ida_scale)
                          for f in mlvl_feats]
        # a camera shard (models/detector.py::shard_cameras) holds cameras
        # [first, first + N) of cfg.num_cams
        rig, first = rig_cameras(self.cam_shard, N, cfg.num_cams)
        past = min(max(cfg.num_frame_cams - first, 0), N)
        if cfg.with_detach and past < N and mlvl_feats[0].requires_grad:
            f0 = mlvl_feats[0]
            mlvl_feats = [torch.cat([f0[:, :past], f0[:, past:].detach()],
                                    dim=1), *mlvl_feats[1:]]

        feats_pe, shapes = [], []
        for feat in mlvl_feats:
            _, _, H, W, _ = feat.shape
            if cfg.with_pe:
                pe = self.position_encoder(
                    self.position_embedding(feat, lidar2img).to(dtype)
                )
                if cfg.with_fpe:
                    pe = (self.fpe(pe, feat, intrinsics)
                          if cfg.fpe_type == "camconv" else self.fpe(pe, feat))
                # all-valid mask: inputs are always padded to the exact
                # network size (:524-539)
                # the camera axis is one of its axes: a shard encodes its
                # cameras of the whole rig
                mask = torch.zeros(B, rig, H, W, device=feat.device)
                sin = sine_positional_encoding_3d(
                    mask, num_feats=cfg.pe_num_feats,
                    cams=slice(first, first + N))
                pe = pe + self.adapt_pos3d(sin.to(dtype))
                feat = feat + pe
            # with_pe False: raw FPN features (detr3d_head.py:16-166)
            feats_pe.append(feat.reshape(B, N, H * W, -1))
            shapes.append((H, W))
        value = torch.cat(feats_pe, dim=2)  # (B, N, sum H*W, C)

        attn_mask = self.self_attn_mask(dev)
        df = (None if not cfg.scale_pred or depth_factors is None
              else depth_factors.float()[:, None, None])
        all_cls, all_bbox, overflow = yield from self.decode_steps(
            self.query_embedding.weight, value, shapes, lidar2img, generator,
            attn_mask, df)
        if attn_mask is None:
            out = {"all_cls_scores": all_cls, "all_bbox_preds": all_bbox,
                   "cam_overflow": overflow}
        else:
            q1 = cfg.num_query  # the groups split (h_detr3d_head_pe.py:361-364)
            out = {
                "all_cls_scores": all_cls[:, :, :q1],
                "all_bbox_preds": all_bbox[:, :, :q1],
                "all_cls_scores_one2many": all_cls[:, :, q1:],
                "all_bbox_preds_one2many": all_bbox[:, :, q1:],
                "cam_overflow": overflow,
            }
        if teacher_query_embed is not None:
            g_cls, g_bbox, g_overflow = yield from self.decode_steps(
                teacher_query_embed.detach(), value, shapes, lidar2img,
                generator, None, df)
            out.update(all_cls_scores_guided=g_cls,
                       all_bbox_preds_guided=g_bbox,
                       cam_overflow_guided=g_overflow)
        return out
