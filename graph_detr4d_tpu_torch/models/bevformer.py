"""BEVFormer's head: a BEV encoder over the cameras, then a deformable
DETR decoder over the BEV (Li et al., "BEVFormer", ECCV 2022; reference:
fundamentalvision/BEVFormer projects/mmdet3d_plugin/bevformer/
dense_heads/bevformer_head.py, modules/transformer.py, encoder.py,
temporal_self_attention.py, spatial_cross_attention.py, decoder.py).

  * PerceptionTransformer: the BEV queries are `bev_embedding` plus the
    can_bus MLP of the frame's ego motion; the camera features get a
    camera and a level embedding; `bev_pos` is a learned row / column
    embedding.
  * The previous frame's BEV (the stream's state, serve.Engine) is
    rotated by the frame's yaw change about the map's centre (torchvision's
    `rotate`: nearest, zero fill), and the temporal queue's reference
    points are shifted by the ego translation, in grid units.
  * Each encoder layer: temporal self-attention (TSA: K1 over the 2
    queues [previous BEV, current queries], 1 level, averaged), norm,
    spatial cross-attention (SCA), norm, FFN, norm.
  * SCA: each BEV cell's pillar of `num_points_in_pillar` heights is
    projected into every camera once a request; a query is in a camera
    if any height is. Each camera samples only its queries, compacted to
    `sca_capacity` rows by the flagship's index list (in-view queries
    first, lowest index first; models/attention.py), 8 points a head and
    level, 2 around each height's projection. The rows' outputs are
    summed back per query and divided by the number of cameras that see
    it. In-view queries past the capacity are dropped and counted
    (`bev_sca_overflow`); 0 means the compaction was exact.
  * The decoder: 900 queries, each layer self-attention, norm, the 2D
    deformable cross-attention over the BEV (models/dgcnn.py::
    BEVDeformableCrossAttn, 1 level), norm, FFN, norm; box refinement and
    the decode as models/head.py::Detr3DHeadPE.decode_steps.

The forward is a `steps` generator (models/k1_graph.py) that yields every
K1 call, TSA's, SCA's and the decoder's, and the opening and closing of
its spans as eager stretches. An eval forward on the card without
autograd replays it as CUDA graphs between those yields (`K1Graphs`, as
the flagship's and MP's heads, models/head.py), K1 launched and the
spans opened and closed between the replays: the first call of an input
signature runs eagerly, the second captures, later calls replay. A
scene's first frame (no previous BEV) and a later one are two
signatures. A replayed call copies its inputs, the previous BEV
included, into the graphs' own and returns fresh tensors, `bev_embed`
and `cam_overflow` included. Anything else runs eagerly. The TSA and
SCA offsets and weights are linears of every BEV query, computed once a
layer; SCA gathers the compacted rows' from them (upstream computes them
on the per-camera rebatched rows: the same numbers).

Spans (tracing.py): `model.head.bev_encoder` around the encoder layers,
`model.head.bev_sca` around each layer's SCA (the gather of the
compacted rows, K1, the sum back and the output projection). Counters:
`bev_sca_rows` on each SpatialCrossAttention, the rows its K1 calls
sampled (cameras x capacity a call), counted as its span closes, and
the head's `bev_sca_overflow`, the in-view queries the capacity dropped,
summed by forward from each call's `cam_overflow`; both since the head
was built.

Module names are the published checkpoint's (`transformer.encoder.
layers.{i}.attentions.1.deformable_attention.sampling_offsets`, ...).
Eval only: no dropout is drawn. At batch B > 1 each sample's TSA reads
its own previous BEV (the published layer reads sample 0's for the
offsets' input: the same at batch 1).
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import tracing
from ..geometry.projection import denormalize_points, project_points_to_cameras
from ..utils.device import device_constant
from ..utils.math import inverse_sigmoid
from .detr_decoder import DeformableDecoderLayer
from .head import Decoder, cls_branch, reg_branch
from .k1_graph import Eager, K1Graphs, run_k1
from .layers import LayerNorm, Linear
from .transformer import FFN

# can_bus (nuScenes' CAN bus as the published converter fills it): the ego
# translation (m) at 0:3, the frame's delta when given to the head
CAN_BUS_DIMS = 18
CAN_YAW_RAD = 16  # ego yaw, radians (absolute)
CAN_YAW_DEG = 17  # ego yaw, degrees; the frame's delta when given
NUM_BEV_QUEUE = 2  # TSA's queues: the previous BEV, the current queries


def bev_shift(can_bus, bev_h, bev_w, grid_hw):
    """(B, 2) shift (x, y) of the previous BEV's reference points, in units
    of the map (get_bev_features): the ego translation (can_bus[:2]) turned
    into the current ego frame by the yaw (can_bus[-2])."""
    can = can_bus.float()
    dx, dy = can[:, 0], can[:, 1]
    ego = can[:, CAN_YAW_RAD] / math.pi * 180
    length = torch.sqrt(dx * dx + dy * dy)
    angle = torch.atan2(dy, dx) / math.pi * 180
    bev_angle = (ego - angle) / 180 * math.pi
    shift_y = length * torch.cos(bev_angle) / grid_hw[0] / bev_h
    shift_x = length * torch.sin(bev_angle) / grid_hw[1] / bev_w
    return torch.stack([shift_x, shift_y], dim=-1)


def rotate_bev(bev, angle_deg, bev_h, bev_w):
    """bev (B, H * W, C) rotated by angle_deg (B,) degrees about the map's
    centre: torchvision's `rotate` (nearest, zero fill), its inverse
    affine grid worked out elementwise in float32 and sampled by
    grid_sample (align_corners False). Returns bev's dtype."""
    B, _, C = bev.shape
    dev = bev.device
    rot = -angle_deg.float() / 180 * math.pi  # rotate passes -angle
    cos, sin = torch.cos(rot)[:, None, None], torch.sin(rot)[:, None, None]
    xs = torch.linspace(-bev_w * 0.5 + 0.5, bev_w * 0.5 - 0.5, bev_w,
                        device=dev)[None, None, :]
    ys = torch.linspace(-bev_h * 0.5 + 0.5, bev_h * 0.5 - 0.5, bev_h,
                        device=dev)[None, :, None]
    gx = (cos * xs + sin * ys) / (0.5 * bev_w)
    gy = (cos * ys - sin * xs) / (0.5 * bev_h)
    grid = torch.stack([gx, gy], dim=-1)  # (B, H, W, 2)
    img = bev.float().view(B, bev_h, bev_w, C).permute(0, 3, 1, 2)
    out = F.grid_sample(img, grid, mode="nearest", padding_mode="zeros",
                        align_corners=False)
    return out.permute(0, 2, 3, 1).reshape(B, bev_h * bev_w, C).to(bev.dtype)


def reference_2d(bev_h, bev_w, device):
    """(H * W, 2) cell centres (x, y) in [0, 1], row-major."""
    ys = torch.linspace(0.5, bev_h - 0.5, bev_h, device=device) / bev_h
    xs = torch.linspace(0.5, bev_w - 0.5, bev_w, device=device) / bev_w
    ref_y, ref_x = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([ref_x.reshape(-1), ref_y.reshape(-1)], dim=-1)


def reference_3d(bev_h, bev_w, num_points, z_range, device):
    """(H * W, D, 3) pillar points (x, y, z) in [0, 1]: D heights at
    linspace(0.5, Z - 0.5, D) / Z of each cell's centre."""
    zs = torch.linspace(0.5, z_range - 0.5, num_points, device=device) / z_range
    xy = reference_2d(bev_h, bev_w, device)
    Q = xy.shape[0]
    return torch.cat([xy[:, None, :].expand(Q, num_points, 2),
                      zs[None, :, None].expand(Q, num_points, 1)], dim=-1)


def learned_bev_pos(row_embed, col_embed):
    """(H * W, C): cat(col_embed[x], row_embed[y]) of each cell, row-major
    (mmdet's LearnedPositionalEncoding)."""
    H, W = row_embed.shape[0], col_embed.shape[0]
    return torch.cat([col_embed[None, :, :].expand(H, W, -1),
                      row_embed[:, None, :].expand(H, W, -1)],
                     dim=-1).reshape(H * W, -1)


class LearnedPositionalEncoding(nn.Module):
    def __init__(self, num_feats, row_num_embed, col_num_embed):
        super().__init__()
        self.row_embed = nn.Embedding(row_num_embed, num_feats)
        self.col_embed = nn.Embedding(col_num_embed, num_feats)


class TemporalSelfAttention(nn.Module):
    """TSA: 2D deformable attention of every BEV query into the 2 queues
    [previous BEV, current queries] at 1 level, the queues averaged."""

    def __init__(self, embed_dims, num_heads, num_points):
        super().__init__()
        C = embed_dims
        self.num_heads, self.num_points = num_heads, num_points
        nq = NUM_BEV_QUEUE
        self.sampling_offsets = Linear(C * nq, nq * num_heads * num_points * 2)
        self.attention_weights = Linear(C * nq, nq * num_heads * num_points)
        self.value_proj = Linear(C, C)
        self.output_proj = Linear(C, C)

    def steps(self, query, query_pos, value, ref_2d, bev_hw):
        """query (B, Q, C); value (B, 2, Q, C): the previous BEV (or the
        query) and the current queries; ref_2d (B, 2, Q, 2) each queue's
        reference points. Yields its K1 call; returns query + update."""
        B, Q, C = query.shape
        nh, P, nq = self.num_heads, self.num_points, NUM_BEV_QUEUE
        H, W = bev_hw
        q = torch.cat([value[:, 0], query + query_pos], dim=-1)
        offsets = self.sampling_offsets(q).view(B, Q, nh, nq, 1, P, 2)
        offsets = offsets.permute(0, 3, 1, 2, 4, 5, 6).float()
        attn = self.attention_weights(q).view(B, Q, nh, nq, P)
        attn = torch.softmax(attn.float(), dim=-1).permute(0, 3, 1, 2, 4)
        wh = device_constant((W, H), torch.float32, query.device)
        loc = ref_2d.float()[:, :, :, None, None, None, :] + offsets / wh
        v = self.value_proj(value).reshape(B * nq, Q, nh, C // nh)
        out = yield (v, [(H, W)], loc.reshape(B * nq, Q, nh, 1, P, 2)
                     .contiguous(), attn.reshape(B * nq, Q, nh, 1, P)
                     .contiguous(), None)
        out = out.view(B, nq, Q, C).float().mean(dim=1).to(query.dtype)
        return query + self.output_proj(out)


class MSDeformableAttention3D(nn.Module):
    """SCA's deformable attention (no output projection of its own): the
    offsets and weights of each BEV query, the value projection."""

    def __init__(self, embed_dims, num_heads, num_levels, num_points):
        super().__init__()
        C = embed_dims
        self.sampling_offsets = Linear(C, num_heads * num_levels * num_points * 2)
        self.attention_weights = Linear(C, num_heads * num_levels * num_points)
        self.value_proj = Linear(C, C)


class SpatialCrossAttention(nn.Module):
    """SCA: each camera's BEV queries sample its features around their
    pillars' projections; the cameras' outputs are summed per query over
    the cameras that see it and divided by their number."""

    def __init__(self, embed_dims, num_heads, num_levels, num_points,
                 num_pillar_points):
        super().__init__()
        self.num_heads, self.num_levels = num_heads, num_levels
        self.num_points, self.num_pillar = num_points, num_pillar_points
        self.deformable_attention = MSDeformableAttention3D(
            embed_dims, num_heads, num_levels, num_points)
        self.output_proj = Linear(embed_dims, embed_dims)
        self.bev_sca_rows = 0
        self._span = None  # the open `model.head.bev_sca`

    def steps(self, query, query_pos, value, shapes, sca):
        """query (B, Q, C); value (B * N, S, C) the cameras' features with
        their embeddings; sca: `SCARows` of the request. Yields its K1
        call inside its span's opening and closing (eager stretches);
        returns query + update."""
        B, Q, C = query.shape
        nh, L, P, D = (self.num_heads, self.num_levels, self.num_points,
                       self.num_pillar)
        da = self.deformable_attention
        yield Eager(self.open_span)
        q = query + query_pos
        offsets = da.sampling_offsets(q).view(B, Q, nh * L * P * 2)
        attn = da.attention_weights(q).view(B, Q, nh, L * P)
        attn = torch.softmax(attn.float(), dim=-1).view(B, Q, nh * L * P)
        # the compacted rows of each camera: (B * N, K, ...)
        rows = sca.rows
        off = offsets[sca.batch, rows].float().view(
            *rows.shape, nh, L, P // D, D, 2)
        wh = device_constant(tuple((w, h) for h, w in shapes), torch.float32,
                             query.device)[:, None, None, :]
        loc = sca.ref_cam[:, :, None, None, None, :, :] + off / wh
        BN, K = rows.shape
        v = da.value_proj(value).view(BN, -1, nh, C // nh)
        out = yield (v, shapes, loc.reshape(BN, K, nh, L, P, 2).contiguous(),
                     attn[sca.batch, rows].view(BN, K, nh, L, P)
                     .contiguous(), None)
        out = out.float() * sca.keep[..., None]
        slots = torch.zeros(B * Q, C, dtype=torch.float32,
                            device=query.device)
        slots.index_add_(0, sca.flat.reshape(-1), out.reshape(-1, C))
        slots = slots.view(B, Q, C) / sca.count[..., None]
        out = self.output_proj(slots.to(query.dtype))
        yield Eager(self.close_span, rows.numel())
        return query + out

    def open_span(self):
        """Opens `model.head.bev_sca` (an eager stretch of `steps`,
        models/k1_graph.py::Eager: it records from a replay of the
        graphs too)."""
        self._span = tracing.span("model.head.bev_sca", device=True).__enter__()

    def close_span(self, rows):
        """Closes it, and counts the K1 call's rows in `bev_sca_rows`."""
        self._span.__exit__(None, None, None)
        self._span = None
        self.bev_sca_rows += rows


class SCARows:
    """What SCA needs of a request's rig, worked out once for all layers:
    `rows` (B * N, K) the compacted BEV queries of each camera, `batch`
    (B * N, 1) their sample, `flat` (B * N, K) their index into the
    (B * Q) queries, `ref_cam` (B * N, K, D, 2) the pillar's projections
    in [0, 1], `keep` (B * N, K) 1 for an in-view row, 0 for padding,
    `count` (B, Q) the cameras that see each query (at least 1) and
    `overflow` the in-view queries the capacity dropped."""

    def __init__(self, ref_3d, lidar2img, pc_range, img_shape, capacity):
        B, N = lidar2img.shape[:2]
        Q, D, _ = ref_3d.shape
        pts = denormalize_points(ref_3d, pc_range).reshape(1, Q * D, 3)
        loc, valid = project_points_to_cameras(
            pts.expand(B, Q * D, 3), lidar2img.float(), img_shape)
        loc, valid = loc.view(B * N, Q, D, 2), valid.view(B * N, Q, D)
        seen = valid.amax(dim=-1)  # (B * N, Q)
        K = min(Q, capacity)
        # stable descending sort: in-view queries first, lower index first
        self.rows = torch.sort(seen, dim=-1, descending=True,
                               stable=True).indices[:, :K]
        self.batch = torch.arange(B, device=loc.device)[:, None].expand(
            B, N).reshape(B * N, 1)
        self.flat = self.rows + self.batch * Q
        self.ref_cam = torch.gather(
            loc, 1, self.rows[..., None, None].expand(-1, -1, D, 2))
        self.keep = torch.gather(seen, 1, self.rows)
        self.count = seen.view(B, N, Q).sum(dim=1).clamp(min=1.0)
        self.overflow = (seen.sum(-1) - K).clamp(min=0.0).sum()


class BEVFormerLayer(nn.Module):
    """TSA, norm, SCA, norm, FFN, norm."""

    def __init__(self, embed_dims, num_heads, num_levels, ffn_dims, bev):
        super().__init__()
        self.attentions = nn.ModuleList([
            TemporalSelfAttention(embed_dims, num_heads, bev.tsa_num_points),
            SpatialCrossAttention(embed_dims, num_heads, num_levels,
                                  bev.sca_num_points, bev.num_points_in_pillar)])
        self.ffns = nn.ModuleList([FFN(embed_dims, ffn_dims, 0.0)])
        self.norms = nn.ModuleList([LayerNorm(embed_dims) for _ in range(3)])

    def steps(self, query, bev_pos, temporal, ref_2d, bev_hw, value, shapes,
              sca):
        """temporal (B, 2, Q, C) TSA's value, or None without a previous
        BEV: then [query, query] of this layer's input."""
        if temporal is None:
            temporal = torch.stack([query, query], dim=1)
        query = yield from self.attentions[0].steps(query, bev_pos, temporal,
                                                    ref_2d, bev_hw)
        query = self.norms[0](query)
        query = yield from self.attentions[1].steps(query, bev_pos, value,
                                                    shapes, sca)
        query = self.norms[1](query)
        return self.norms[2](self.ffns[0](query))


class PerceptionTransformer(nn.Module):
    """The published `transformer`: the embeddings, the can_bus MLP, the
    decoder's reference-point projection, the encoder and decoder."""

    def __init__(self, cfg):
        super().__init__()
        h, bev = cfg.head, cfg.bev
        C = h.embed_dims
        self.level_embeds = nn.Parameter(torch.empty(h.num_levels, C))
        self.cams_embeds = nn.Parameter(torch.empty(h.num_cams, C))
        self.reference_points = Linear(C, 3)
        self.can_bus_mlp = nn.Sequential(
            Linear(CAN_BUS_DIMS, C // 2), nn.ReLU(), Linear(C // 2, C),
            nn.ReLU())
        self.can_bus_mlp.add_module("norm", LayerNorm(C))
        # head.Decoder: a holder of `layers`, the published names
        self.encoder = Decoder([
            BEVFormerLayer(C, h.num_heads, h.num_levels, h.ffn_dims, bev)
            for _ in range(bev.num_encoder_layers)])
        self.decoder = Decoder([
            DeformableDecoderLayer(C, h.num_heads, 1, h.num_points,
                                   h.ffn_dims, 0.0)
            for _ in range(h.num_decoder_layers)])


class BEVFormerHead(nn.Module):
    """forward(mlvl_feats L x (B, N, h, w, C), lidar2img (B, N, 4, 4),
    can_bus (B, 18) the frame's ego motion (translation and yaw deltas
    since the previous frame, zero on a scene's first), prev_bev (B, H * W,
    C) or None) -> {'all_cls_scores' (layers, B, Q, classes),
    'all_bbox_preds' (layers, B, Q, 10), 'bev_embed' (B, H * W, C) in the
    compute dtype, 'cam_overflow' (SCA's dropped in-view queries)}.
    Eagerly or as CUDA graphs (`self.graphs`), as the module's docstring
    says; `graphed` decides."""

    def __init__(self, cfg):
        super().__init__()
        h, bev = cfg.head, cfg.bev
        C = h.embed_dims
        self.cfg = cfg
        self.img_shape = tuple(cfg.img_size)
        self.graphs = K1Graphs()  # the eval forward's CUDA graphs
        self._overflow = None  # a device scalar: SCA's dropped queries
        self._encoder = None  # the open `model.head.bev_encoder`
        self.bev_embedding = nn.Embedding(bev.bev_h * bev.bev_w, C)
        self.query_embedding = nn.Embedding(h.num_query, 2 * C)
        self.positional_encoding = LearnedPositionalEncoding(
            C // 2, bev.bev_h, bev.bev_w)
        self.transformer = PerceptionTransformer(cfg)
        self.cls_branches = nn.ModuleList(
            cls_branch(C, h.num_classes, h.num_reg_fcs)
            for _ in range(h.num_decoder_layers))
        self.reg_branches = nn.ModuleList(
            reg_branch(C, h.code_size, h.num_reg_fcs)
            for _ in range(h.num_decoder_layers))

    @property
    def bev_sca_overflow(self) -> float:
        return 0.0 if self._overflow is None else float(self._overflow)

    def forward(self, mlvl_feats, lidar2img, can_bus=None, prev_bev=None):
        mlvl_feats = list(mlvl_feats)
        if self.graphed(mlvl_feats[0]):
            L = len(mlvl_feats)
            out = self.graphs(lambda *t: self.steps(list(t[:L]), *t[L:]),
                              [*mlvl_feats, lidar2img, can_bus, prev_bev])
        else:
            out = run_k1(self.steps(mlvl_feats, lidar2img, can_bus, prev_bev))
        overflow = out["cam_overflow"].detach()
        self._overflow = (overflow if self._overflow is None
                          else self._overflow + overflow)
        return out

    def graphed(self, feat) -> bool:
        """Whether forward replays CUDA graphs (see the class)."""
        return (feat.is_cuda and not self.training
                and not torch.is_grad_enabled())

    def open_encoder(self):
        """Opens `model.head.bev_encoder` (an eager stretch of `steps`)."""
        self._encoder = tracing.span("model.head.bev_encoder",
                                     device=True).__enter__()

    def close_encoder(self):
        """Closes it (an eager stretch)."""
        self._encoder.__exit__(None, None, None)
        self._encoder = None

    def steps(self, mlvl_feats, lidar2img, can_bus=None, prev_bev=None):
        """forward as a generator of its K1 calls and eager stretches
        (models/k1_graph.py)."""
        cfg, h, bev = self.cfg, self.cfg.head, self.cfg.bev
        tr = self.transformer
        dtype, dev = mlvl_feats[0].dtype, mlvl_feats[0].device
        B, N = mlvl_feats[0].shape[:2]
        C, bh, bw = h.embed_dims, bev.bev_h, bev.bev_w
        pc = h.pc_range
        if can_bus is None:
            can_bus = torch.zeros(B, CAN_BUS_DIMS, device=dev)
        can_bus = can_bus.float()

        yield Eager(self.open_encoder)
        # the cameras' value: features + camera and level embeddings
        values, shapes = [], []
        for lvl, f in enumerate(mlvl_feats):
            _, _, H, W, _ = f.shape
            f = (f.reshape(B, N, H * W, C) + tr.cams_embeds.to(dtype)[None, :, None]
                 + tr.level_embeds[lvl].to(dtype))
            values.append(f)
            shapes.append((H, W))
        value = torch.cat(values, dim=2).reshape(B * N, -1, C)

        query = (self.bev_embedding.weight.to(dtype)[None]
                 + tr.can_bus_mlp(can_bus.to(dtype))[:, None])
        bev_pos = learned_bev_pos(self.positional_encoding.row_embed.weight,
                                  self.positional_encoding.col_embed.weight)
        bev_pos = bev_pos.to(dtype)[None].expand(B, -1, -1)
        ref_2d = reference_2d(bh, bw, dev)[None].expand(B, -1, -1)
        if prev_bev is None:
            temporal = None
            hybrid = torch.stack([ref_2d, ref_2d], dim=1)
        else:
            grid = ((pc[4] - pc[1]) / bh, (pc[3] - pc[0]) / bw)
            shift = bev_shift(can_bus, bh, bw, grid)
            prev = rotate_bev(prev_bev, can_bus[:, CAN_YAW_DEG], bh, bw)
            temporal = torch.stack([prev.to(dtype), query], dim=1)
            hybrid = torch.stack([ref_2d + shift[:, None], ref_2d], dim=1)
        sca = SCARows(reference_3d(bh, bw, bev.num_points_in_pillar,
                                   pc[5] - pc[2], dev),
                      lidar2img, pc, self.img_shape, bev.sca_capacity)
        for layer in tr.encoder.layers:
            query = yield from layer.steps(query, bev_pos, temporal, hybrid,
                                           (bh, bw), value, shapes, sca)
        yield Eager(self.close_encoder)
        bev_embed = query

        # the decoder over the BEV (decoder.py, bevformer_head.py)
        query_pos, q = self.query_embedding.weight.split(C, dim=1)
        query_pos = query_pos[None].to(dtype).expand(B, -1, -1)
        q = q[None].to(dtype).expand(B, -1, -1)
        reference_points = torch.sigmoid(tr.reference_points(query_pos.float()))
        bev_map = [bev_embed.view(B, bh, bw, C)]
        cls_scores, bbox_preds = [], []
        for lid, layer in enumerate(tr.decoder.layers):
            q = yield from layer.steps(q, query_pos, bev_map,
                                       reference_points[..., None, :2])
            score = self.cls_branches[lid](q)
            tmp = self.reg_branches[lid](q).float()
            ref = inverse_sigmoid(reference_points)
            xy = torch.sigmoid(tmp[..., 0:2] + ref[..., 0:2])
            z = torch.sigmoid(tmp[..., 4:5] + ref[..., 2:3])
            cx = xy[..., 0:1] * (pc[3] - pc[0]) + pc[0]
            cy = xy[..., 1:2] * (pc[4] - pc[1]) + pc[1]
            cz = z * (pc[5] - pc[2]) + pc[2]
            bbox_preds.append(torch.cat([cx, cy, tmp[..., 2:4], cz, tmp[..., 5:]],
                                        dim=-1))
            cls_scores.append(score.float())
            reference_points = torch.cat([xy, z], dim=-1).detach()
        return {"all_cls_scores": torch.stack(cls_scores),
                "all_bbox_preds": torch.stack(bbox_preds),
                "bev_embed": bev_embed, "cam_overflow": sca.overflow}
