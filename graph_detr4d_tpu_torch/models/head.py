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
gradient (:512-516). Public tensors keep the JAX layouts: features L x
(B, N, H, W, C), outputs (layers, B, Q, .).
"""

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from ..config import HeadConfig
from ..geometry.projection import inv4x4
from ..utils.math import inverse_sigmoid
from .layers import LayerNorm, Linear, SELayer, two_layer_mlp
from .positional import lid_depth_bins, sine_positional_encoding_3d
from .transformer import DecoderLayer


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
            )
            for _ in range(cfg.num_decoder_layers)
        ])


class Detr3DHeadPE(nn.Module):
    def __init__(self, cfg: HeadConfig, img_shape: Tuple[int, int]):
        super().__init__()
        self.cfg = cfg
        self.img_shape = tuple(img_shape)
        C = cfg.embed_dims
        self.query_embedding = nn.Embedding(cfg.num_query, 2 * C)
        self.transformer = Transformer(cfg)
        if cfg.with_pe:  # the plain Detr3DHead (with_pe False) has none
            self.position_encoder = two_layer_mlp(cfg.depth_num * 3, 4 * C, C)
            self.adapt_pos3d = two_layer_mlp(cfg.pe_num_feats * 3, 4 * C, C)
            self.fpe = SELayer(C)
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
        B, N, H, W, _ = feat.shape
        pad_h, pad_w = self.img_shape
        dev = feat.device
        eps = 1e-5
        coords_h = torch.arange(H, dtype=torch.float32, device=dev) * pad_h / H
        coords_w = torch.arange(W, dtype=torch.float32, device=dev) * pad_w / W
        d = lid_depth_bins(cfg.depth_num, cfg.depth_start, cfg.pc_range[3],
                           device=dev).clamp(min=eps)
        D = cfg.depth_num
        shape = (H, W, D)
        coords = torch.stack([
            (coords_w[None, :, None] * d).expand(shape),
            (coords_h[:, None, None] * d).expand(shape),
            d.expand(shape),
            torch.ones(shape, device=dev),
        ], dim=-1)  # (H, W, D, 4) homogeneous (x*d, y*d, d, 1)
        img2lidar = inv4x4(lidar2img)
        p3d = torch.einsum("bnij,hwdj->bnhwdi", img2lidar, coords)[..., :3]
        lo = torch.tensor(cfg.pc_range[:3], device=dev)
        hi = torch.tensor(cfg.pc_range[3:], device=dev)
        p3d = inverse_sigmoid((p3d - lo) / (hi - lo))
        return p3d.reshape(B, N, H, W, D * 3)

    def forward(self, mlvl_feats, lidar2img, generator=None):
        """mlvl_feats: L x (B, N, H, W, C) in the compute dtype;
        lidar2img (B, N, 4, 4); generator: dropout's random source in
        training, None in eval. Returns {'all_cls_scores' (layers, B, Q,
        classes), 'all_bbox_preds' (layers, B, Q, code), 'cam_overflow'}.
        """
        cfg = self.cfg
        dtype = mlvl_feats[0].dtype
        B, N = mlvl_feats[0].shape[:2]
        lidar2img = lidar2img.float()
        nf = cfg.num_frame_cams
        if cfg.with_detach and N > nf and mlvl_feats[0].requires_grad:
            f0 = mlvl_feats[0]
            mlvl_feats = [torch.cat([f0[:, :nf], f0[:, nf:].detach()], dim=1),
                          *mlvl_feats[1:]]

        feats_pe, shapes = [], []
        for feat in mlvl_feats:
            _, _, H, W, _ = feat.shape
            if cfg.with_pe:
                pe = self.position_encoder(
                    self.position_embedding(feat, lidar2img).to(dtype)
                )
                pe = self.fpe(pe, feat)
                # all-valid mask: inputs are always padded to the exact
                # network size (:524-539)
                mask = torch.zeros(B, N, H, W, device=feat.device)
                sin = sine_positional_encoding_3d(mask,
                                                  num_feats=cfg.pe_num_feats)
                pe = pe + self.adapt_pos3d(sin.to(dtype))
                feat = feat + pe
            # with_pe False: raw FPN features (detr3d_head.py:16-166)
            feats_pe.append(feat.reshape(B, N, H * W, -1))
            shapes.append((H, W))
        value = torch.cat(feats_pe, dim=2)  # (B, N, sum H*W, C)

        C = cfg.embed_dims
        query_pos, query = self.query_embedding.weight.split(C, dim=1)
        query_pos = query_pos[None].to(dtype).expand(B, -1, -1)
        query = query[None].to(dtype).expand(B, -1, -1)
        reference_points = torch.sigmoid(
            self.transformer.reference_points(query_pos.float())
        )

        pc = cfg.pc_range
        cls_scores, bbox_preds, overflow = [], [], 0.0
        for lid, layer in enumerate(self.transformer.decoder.layers):
            query, ov = layer(query, query_pos, value, shapes,
                              reference_points, lidar2img, self.img_shape,
                              generator)
            overflow = overflow + ov
            score = self.cls_branches[lid](query)
            tmp = self.reg_branches[lid](query).float()

            ref = inverse_sigmoid(reference_points)
            xy = torch.sigmoid(tmp[..., 0:2] + ref[..., 0:2])
            z = torch.sigmoid(tmp[..., 4:5] + ref[..., 2:3])
            cx = xy[..., 0:1] * (pc[3] - pc[0]) + pc[0]
            cy = xy[..., 1:2] * (pc[4] - pc[1]) + pc[1]
            cz = z * (pc[5] - pc[2]) + pc[2]
            bbox_preds.append(
                torch.cat([cx, cy, tmp[..., 2:4], cz, tmp[..., 5:]], dim=-1)
            )
            cls_scores.append(score.float())
            # iterative refinement (detr3d_transformer.py:201-214)
            reference_points = torch.cat([xy, z], dim=-1).detach()
        return {
            "all_cls_scores": torch.stack(cls_scores),
            "all_bbox_preds": torch.stack(bbox_preds),
            "cam_overflow": overflow,
        }
