"""The LiDAR branch: ObjDGCNN with its DGCNN3DHead (counterpart of
graph_detr4d_tpu/models/dgcnn.py; reference:
models/detectors/obj_dgcnn.py:8-143, dense_heads/dgcnn3d_head.py:18-483,
utils/dgcnn_attn.py:9-96).

    points (B, P, F) -> PillarEncoder (K6: ids + augmented rows, per-point
    Linear + LayerNorm + relu, max-scatter into the (H, W) BEV grid)
    -> SECONDBackbone -> SECONDFPN (4 levels) -> DGCNN3DHead: 900 queries,
    6 layers of DGCNN k-NN self-attention + BEV multi-scale deformable
    cross-attention (K1, no index list) + FFN, iterative xy refinement.

The outputs are the 10-d detr3d codes with metric cx, cy, decoded by
core/coder.decode_batch. Tensors are channels-last (B, H, W, C) as in the
JAX modules, and the module and parameter names mirror the JAX tree
(`pillar_encoder.pfn`, `pts_backbone.stage1_down`,
`pts_bbox_head.layer0_cross_attn.value_proj`, ...). Where flax names a
module by creation order (the SECOND LayerNorms and FPN convs, the head's
FFN Dense layers) the port gives it a name and weights.py maps the order.
The JAX module's departures from upstream (dense pillar scatter for the
hard voxelizer, LayerNorm for BatchNorm in the SECOND and pillar layers,
frozen BN in the edge convs) are kept, so no upstream checkpoint loads
into either. Inference only; no dropout is drawn.
"""

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import HeadConfig
from ..ops import voxelize
from ..utils.device import device_constant, resolve_device
from ..utils.math import inverse_sigmoid
from .head import cls_branch, reg_branch
from .k1_graph import K1Module
from .layers import Conv2d, FrozenBatchNorm, LayerNorm, Linear, dropout
from .positional import sine_positional_encoding_2d

DEFAULT_PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)


def knn_farthest(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, C) -> (B, N, k) indices of the k LARGEST squared distances
    (the reference's topk-of-cdist quirk, dgcnn_attn.py:85-87), computed
    by the matmul identity as the JAX module does, so near-ties fall the
    same way. The max over neighbours makes their order irrelevant."""
    sq = (x * x).sum(-1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.matmul(
        x, x.transpose(1, 2))
    return torch.topk(d2, k, dim=-1).indices


def neighbour_max(y: torch.Tensor) -> torch.Tensor:
    """(B, N, k, C) -> (B, N, C), the max over the k neighbours: a choice of
    one neighbour per channel, as discontinuous as knn_farthest's, so a
    comparison of two numerically different routes can hold it fixed."""
    return y.amax(dim=2)


class DGCNNAttn(nn.Module):
    """k-NN graph self-attention (dgcnn_attn.py:9-96): two edge convs
    (Linear over [neighbour, centre] + frozen BN + relu, max over the k
    neighbours), the second on the first's output, summed, residual."""

    def __init__(self, embed_dims: int, k: int = 16):
        super().__init__()
        self.k = k
        C = embed_dims
        self.conv1 = Linear(2 * C, C, bias=False)
        self.conv1_bn = FrozenBatchNorm(C, channels_last=True)
        self.conv2 = Linear(2 * C, C, bias=False)
        self.conv2_bn = FrozenBatchNorm(C, channels_last=True)

    def edge_conv(self, x, lin, bn):
        """The Linear over the concatenated [neighbour, centre] row, split
        into its two halves so each point is projected once (the same sum
        in another order): (B, N, C) -> (B, N, C)."""
        B, N, C = x.shape
        idx = knn_farthest(x, self.k)
        w = lin.weight.to(x.dtype)  # (C_out, 2C): [neighbour | centre]
        nb = F.linear(x, w[:, :C])
        ctr = F.linear(x, w[:, C:])
        rows = torch.arange(B, device=x.device)[:, None, None]
        y = nb[rows, idx] + ctr[:, :, None]  # (B, N, k, C_out)
        return neighbour_max(F.relu(bn(y)))

    def forward(self, query, query_pos=None):
        x = query if query_pos is None else query + query_pos
        e1 = self.edge_conv(x, self.conv1, self.conv1_bn)
        e2 = self.edge_conv(e1, self.conv2, self.conv2_bn)
        return query + (e1 + e2)


def grid_offset_bias(num_heads: int, num_levels: int, num_points: int):
    """Deformable-DETR circular offset init (8 directions x growing
    radius), flattened as (heads, levels, points, 2)."""
    thetas = torch.arange(num_heads, dtype=torch.float32) * (
        2.0 * torch.pi / num_heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = grid / grid.abs().amax(-1, keepdim=True)
    grid = grid[:, None, None, :].repeat(1, num_levels, num_points, 1)
    grid = grid * torch.arange(1, num_points + 1, dtype=torch.float32)[
        None, None, :, None]
    return grid.reshape(-1)


class BEVDeformableCrossAttn(K1Module):
    """2D multi-scale deformable attention over a feature pyramid (mmcv's
    MultiScaleDeformableAttention): offsets normalised by each level's
    (W, H), softmax over levels x points, K1 over all queries. The BEV
    pyramid's cross-attention here; the generic deformable decoder's
    (models/detr_decoder.py) with per-level reference points and, in
    training, dropout on the output; BEVFormer's decoder's over its one
    BEV level (models/bevformer.py). Written as a `steps` generator of its
    one K1 call (models/k1_graph.py); forward runs it eagerly."""

    def __init__(self, embed_dims: int, num_heads: int = 8,
                 num_levels: int = 4, num_points: int = 4,
                 dropout: float = 0.0):
        super().__init__()
        C = embed_dims
        self.num_heads, self.num_levels = num_heads, num_levels
        self.num_points, self.dropout = num_points, dropout
        self.sampling_offsets = Linear(C, num_heads * num_levels * num_points * 2)
        self.attention_weights = Linear(C, num_heads * num_levels * num_points)
        self.value_proj = Linear(C, C)
        self.output_proj = Linear(C, C)

    def steps(self, query, values: Sequence[torch.Tensor], reference_points,
              query_pos, generator=None):
        """query (B, Q, C); values L x (B, H_l, W_l, C); reference_points
        (B, Q, 2), or (B, Q, L, 2) one per level, in [0, 1] as (x, y);
        generator: the output dropout's random source in training."""
        B, Q, C = query.shape
        Hh, L, P = self.num_heads, self.num_levels, self.num_points
        q = query + query_pos
        offsets = self.sampling_offsets(q).view(B, Q, Hh, L, P, 2).float()
        attn = self.attention_weights(q).view(B, Q, Hh, L * P)
        attn = torch.softmax(attn.float(), -1).view(B, Q, Hh, L, P)
        shapes = [(v.shape[1], v.shape[2]) for v in values]
        wh = device_constant(tuple((w, h) for h, w in shapes), torch.float32,
                             query.device)
        ref = reference_points.float()
        if ref.dim() == 3:
            ref = ref[:, :, None]  # one point for every level
        # loc and attn stay float32 into K1, as on the camera path
        loc = (ref[:, :, None, :, None, :]
               + offsets / wh[None, None, None, :, None, :])
        value = self.value_proj(torch.cat(
            [v.reshape(B, -1, C) for v in values], dim=1))
        out = yield (value.view(B, -1, Hh, C // Hh), shapes, loc.contiguous(),
                     attn.contiguous(), None)
        return query + dropout(self.output_proj(out), self.dropout, generator)


class DGCNN3DHead(nn.Module):
    """BEV set-prediction head (dgcnn3d_head.py:18-483): learned queries,
    per layer DGCNNAttn, LN, BEVDeformableCrossAttn, LN, FFN, LN; untied
    cls / reg branches; xy refined in inverse-sigmoid space against the
    reference point entering the layer, then detached."""

    def __init__(self, cfg: HeadConfig, knn_k: int = 16):
        super().__init__()
        self.cfg = cfg
        C = cfg.embed_dims
        self.query_embedding = nn.Embedding(cfg.num_query, 2 * C)
        self.reference_points = Linear(C, 2)
        for lid in range(cfg.num_decoder_layers):
            self.add_module(f"layer{lid}_self_attn", DGCNNAttn(C, knn_k))
            self.add_module(f"layer{lid}_norm1", LayerNorm(C))
            self.add_module(f"layer{lid}_cross_attn", BEVDeformableCrossAttn(
                C, cfg.num_heads, cfg.num_levels, cfg.num_points))
            self.add_module(f"layer{lid}_norm2", LayerNorm(C))
            self.add_module(f"layer{lid}_ffn", nn.Sequential(
                Linear(C, cfg.ffn_dims), nn.ReLU(), Linear(cfg.ffn_dims, C)))
            self.add_module(f"layer{lid}_norm3", LayerNorm(C))
            self.add_module(f"cls_branch{lid}", cls_branch(
                C, cfg.num_classes, cfg.num_reg_fcs))
            self.add_module(f"reg_branch{lid}", reg_branch(
                C, cfg.code_size, cfg.num_reg_fcs))

    def forward(self, bev_levels: Sequence[torch.Tensor]):
        """bev_levels L x (B, H_l, W_l, C) -> {'all_cls_scores' (layers, B,
        Q, classes), 'all_bbox_preds' (layers, B, Q, code_size)}."""
        cfg = self.cfg
        C = cfg.embed_dims
        B = bev_levels[0].shape[0]
        pr = cfg.pc_range
        qe = self.query_embedding.weight[None].expand(B, -1, -1)
        query_pos, query = qe[..., :C], qe[..., C:]
        ref = torch.sigmoid(self.reference_points(query_pos.float()))
        # the sine PE is an additive constant of the values, folded in
        # before value_proj (dgcnn.py:244-250 of the JAX package)
        levels = [v + sine_positional_encoding_2d(
            v.shape[1], v.shape[2], C // 2, device=v.device).to(v.dtype)[None]
            for v in bev_levels]
        cls_scores, bbox_preds = [], []
        for lid in range(cfg.num_decoder_layers):
            layer = lambda name: getattr(self, f"layer{lid}_{name}")  # noqa: E731
            query = layer("norm1")(layer("self_attn")(query, query_pos))
            query = layer("norm2")(layer("cross_attn")(query, levels, ref,
                                                       query_pos))
            query = layer("norm3")(query + layer("ffn")(query))
            score = getattr(self, f"cls_branch{lid}")(query).float()
            tmp = getattr(self, f"reg_branch{lid}")(query).float()
            xy = torch.sigmoid(tmp[..., 0:2] + inverse_sigmoid(ref))
            cx = xy[..., 0:1] * (pr[3] - pr[0]) + pr[0]
            cy = xy[..., 1:2] * (pr[4] - pr[1]) + pr[1]
            cls_scores.append(score)
            bbox_preds.append(torch.cat([cx, cy, tmp[..., 2:]], dim=-1))
            ref = xy.detach()
        return {"all_cls_scores": torch.stack(cls_scores),
                "all_bbox_preds": torch.stack(bbox_preds)}


class PillarEncoder(nn.Module):
    """pts_voxel_encoder + middle encoder as one dense op: K6's augmented
    rows [point..., dx_c, dy_c, dx_m, dy_m, dz_m], a per-point Linear +
    LayerNorm + relu, then K6's max-scatter into the (H, W) grid."""

    def __init__(self, point_features: int = 5, out_channels: int = 64,
                 pc_range: Tuple[float, ...] = DEFAULT_PC_RANGE,
                 grid_hw: Tuple[int, int] = (128, 128)):
        super().__init__()
        self.pc_range = tuple(pc_range)
        self.grid_hw = tuple(grid_hw)
        self.pfn = Linear(point_features + 5, out_channels)
        self.pfn_norm = LayerNorm(out_channels)

    def forward(self, points, mask):
        """points (B, P, F) float32, mask (B, P) -> (B, H, W, C)."""
        ids, aug = voxelize.pillar_features(points, mask, self.pc_range,
                                            self.grid_hw)
        feats = F.relu(self.pfn_norm(self.pfn(aug)))
        return voxelize.pillar_scatter(feats, ids, self.grid_hw)


def same_pad(x, stride: int, kernel: int = 3):
    """flax 'SAME' padding of an NCHW tensor for a square conv: total
    max((ceil(n / s) - 1) * s + k - n, 0) per axis, the smaller half
    before. A stride-2 3x3 conv on an even size pads (0, 1), not (1, 1)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad order: W, then H
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _conv_nhwc(conv, x):
    """A conv (no padding of its own) with flax 'SAME' padding, on a
    (B, H, W, C) tensor."""
    y = conv(same_pad(x.permute(0, 3, 1, 2), conv.stride[0],
                      conv.kernel_size[0]))
    return y.permute(0, 2, 3, 1)


class SECONDBackbone(nn.Module):
    """SECOND-style BEV conv backbone: per stage a 3x3 conv (stride 1,
    then 2) + LayerNorm + relu, then residual 3x3 conv + LayerNorm
    blocks."""

    def __init__(self, in_channels: int = 64,
                 channels: Sequence[int] = (64, 128, 256),
                 num_blocks: Sequence[int] = (3, 5, 5)):
        super().__init__()
        self.num_blocks = tuple(num_blocks)
        for s, (ch, nb) in enumerate(zip(channels, num_blocks)):
            stride = 1 if s == 0 else 2
            self.add_module(f"stage{s}_down",
                            Conv2d(in_channels, ch, 3, stride=stride))
            self.add_module(f"stage{s}_down_norm", LayerNorm(ch))
            for b in range(nb):
                self.add_module(f"stage{s}_conv{b}", Conv2d(ch, ch, 3))
                self.add_module(f"stage{s}_norm{b}", LayerNorm(ch))
            in_channels = ch

    def forward(self, x):
        """x (B, H, W, C) -> a list of the stages' outputs."""
        outs = []
        for s, nb in enumerate(self.num_blocks):
            m = lambda name: getattr(self, f"stage{s}_{name}")  # noqa: E731
            x = F.relu(m("down_norm")(_conv_nhwc(m("down"), x)))
            for b in range(nb):
                y = m(f"norm{b}")(_conv_nhwc(m(f"conv{b}"), x))
                x = F.relu(x + y)
            outs.append(x)
        return outs


def nearest_indices(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """Source rows of jax.image.resize(method='nearest') from n_in to n_out:
    floor((i + 0.5) * n_in / n_out), half-pixel centres, as XLA evaluates
    it in float32 (the constant n_in / n_out folded to n_in * (1 / n_out)).
    F.interpolate(mode='nearest-exact') differs from it at some ratios
    other than 2."""
    f32 = dict(dtype=torch.float32, device=device)
    scale = torch.tensor(float(n_in), **f32) * (
        torch.tensor(1.0, **f32) / torch.tensor(float(n_out), **f32))
    i = torch.arange(n_out, **f32)
    return torch.floor((i + 0.5) * scale).long().clamp(max=n_in - 1)


def resize_nearest(x, hw: Tuple[int, int]):
    """(B, H, W, C) -> (B, h, w, C) by `nearest_indices` on each axis."""
    iy = nearest_indices(x.shape[1], hw[0], x.device)
    ix = nearest_indices(x.shape[2], hw[1], x.device)
    return x[:, iy][:, :, ix]


class SECONDFPN(nn.Module):
    """1x1 laterals, top-down nearest-upsample sums, 3x3 output convs, then
    stride-2 3x3 convs on the last output until `num_outs` levels."""

    def __init__(self, in_channels: Sequence[int] = (64, 128, 256),
                 out_channels: int = 256, num_outs: int = 4):
        super().__init__()
        self.num_outs = num_outs
        n = len(in_channels)
        self.lateral_convs = nn.ModuleList(
            Conv2d(c, out_channels, 1) for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            Conv2d(out_channels, out_channels, 3) for _ in range(n))
        self.extra_convs = nn.ModuleList(
            Conv2d(out_channels, out_channels, 3, stride=2)
            for _ in range(max(num_outs - n, 0)))

    def forward(self, feats):
        laterals = [_conv_nhwc(conv, f)
                    for conv, f in zip(self.lateral_convs, feats)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_nearest(
                laterals[i], laterals[i - 1].shape[1:3])
        outs = [_conv_nhwc(conv, lat)
                for conv, lat in zip(self.fpn_convs, laterals)]
        for conv in self.extra_convs:
            outs.append(_conv_nhwc(conv, outs[-1]))
        return outs[: self.num_outs]


class ObjDGCNN(nn.Module):
    """LiDAR detector: pillarize -> SECOND -> FPN -> DGCNN3DHead
    (obj_dgcnn.py:8-143), float32. Defaults are the JAX module's: a
    128 x 128 grid, 64 pillar channels, k = 16 neighbours, and the head
    from `head_cfg` (HeadConfig's defaults: 900 queries, width 256, 6
    layers, 8 heads, 4 levels, 4 points, ffn 512)."""

    def __init__(self, head_cfg: HeadConfig = HeadConfig(),
                 grid_hw: Tuple[int, int] = (128, 128),
                 pillar_channels: int = 64, knn_k: int = 16,
                 point_features: int = 5, device="cuda"):
        dev = resolve_device(device)
        super().__init__()
        self.head_cfg = head_cfg
        C = head_cfg.embed_dims
        self.pillar_encoder = PillarEncoder(
            point_features, pillar_channels, head_cfg.pc_range, grid_hw)
        channels = (pillar_channels, pillar_channels * 2, C)
        self.pts_backbone = SECONDBackbone(pillar_channels, channels)
        self.pts_neck = SECONDFPN(channels, C, head_cfg.num_levels)
        self.pts_bbox_head = DGCNN3DHead(head_cfg, knn_k)
        self.to(dev)

    def forward(self, points: torch.Tensor, mask: torch.Tensor):
        """points (B, P, F) float32 (xyz first), mask (B, P) validity ->
        the head's outputs."""
        bev = self.pillar_encoder(points, mask)
        return self.pts_bbox_head(self.pts_neck(self.pts_backbone(bev)))
