"""Plain float32 reference of BEVFormer-base (bevformer_base, Li et al.,
ECCV 2022; fundamentalvision/BEVFormer projects/configs/bevformer/
bevformer_base.py): ResNet-101 in mmcv's caffe style (the stride on each
stage's first 1x1 conv) with DCNv2 on stages 3-4 and frozen BN, an FPN
from C3 with one extra output, the BEV encoder (6 layers of temporal
self-attention over the previous BEV, spatial cross-attention into the
cameras, FFN) and the 900-query deformable decoder over the BEV with box
refinement.

Written from the published code (projects/mmdet3d_plugin/bevformer/
modules/transformer.py, encoder.py, temporal_self_attention.py,
spatial_cross_attention.py, decoder.py, dense_heads/bevformer_head.py,
and torchvision's rotate) with the weights' published names. Nothing of
the measured program is imported. The layers shared with the flagship
(the convolutions, DCN, FPN, bilinear sampling, multi-head attention, the
decode) are reference/common.py's and reference/flagship.py's.

Departures from the published code, each exact in real arithmetic or
noted where it is not:

  * SCA's offsets and attention weights are linears of every BEV query,
    and each camera's rows gather theirs (the published module computes
    them on the per-camera rebatched rows: the same numbers); the
    per-camera `nonzero` index lists padded to the longest, the
    scatter-add over cameras and the division by the count are as
    published. On the `meta` device (benchmark/flops/count.py) every
    query is in every camera's list: the lists only choose rows, the
    FLOPs are the linears';
  * multi-scale deformable attention gathers its four corners explicitly
    (reference/flagship.py::msda), not mmcv's kernel;
  * the rotation of the previous BEV is torchvision's `rotate` (nearest,
    zero fill, about the map's centre, [100, 100] for 200 x 200), its
    affine grid worked out elementwise in float32 rather than by a
    product with the 2 x 3 matrix: the two round differently in the last
    bit of a grid coordinate, which can move a nearest sample only at an
    exact tie;
  * the grid length of the shift is the map's metric size over its cells
    (0.512 m at 200 x 200, as published) and the rotation centre the
    map's centre, so that a smaller map (the tests') is a consistent one;
  * at batch B > 1 each sample's TSA reads its own previous BEV (the
    published layer reads sample 0's for its offsets' input; the same at
    batch 1, the benchmark's);
  * everything is float32 with TF32 off; the program computes in
    bfloat16 with float32 softmax, projections, sampling locations and
    decode.

`model` is the configuration file's "model" object, read by name.
"""

import math

import numpy as np
import torch

from . import flagship
from .common import inverse_sigmoid
from .flagship import (CLS_PRIOR_BIAS, REG_OUT_SCALE, STAGE_BLOCKS, _linear,
                       _ln, _xavier, deform_conv, fpn, msda)

CAN_BUS_DIMS = 18
CAN_YAW_RAD, CAN_YAW_DEG = 16, 17  # can_bus[-2], can_bus[-1]
NUM_BEV_QUEUE = 2  # TSA's queues: the previous BEV, the current queries
# ResNet-101's residual stream grows over stage 3's 23 blocks; at
# flagship.py's lecun scale the last blocks' seeded DCN offsets reach 7.5
# px rms (the flagship's ResNet-50: 1.4-1.8), where bfloat16's rounding of
# a sampling position moves the sample by more than it rounds the value,
# and the features of a sound bfloat16 run drift 0.04-0.19 from float32,
# seed by seed, as far as the float8 control's 0.20-0.36. At a quarter
# the offsets are 0.6-1.9 px rms, as the flagship's (CPU, 256x448).
OFFSET_WEIGHT_SCALE = 0.25


# ------------------------------------------------------------ parameters
def grid_bias(num_heads, groups, num_points):
    """Deformable DETR's circular offset bias, (heads, groups, points, 2)
    flattened: 8 directions, the i-th point at i + 1."""
    th = np.arange(num_heads, dtype=np.float32) * (2.0 * math.pi / num_heads)
    grid = np.stack([np.cos(th), np.sin(th)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, groups, num_points, 1))
    grid = grid * np.arange(1, num_points + 1, dtype=np.float32)[None, None, :, None]
    return tuple(float(v) for v in grid.reshape(-1))


def head_specs(specs, pre, model):
    h, bev = model["head"], model["bev"]
    C, nh, L, N = h["embed_dims"], h["num_heads"], h["num_levels"], h["num_cams"]
    Pt, Ps, Pd, nq = (bev["tsa_num_points"], bev["sca_num_points"],
                      h["num_points"], NUM_BEV_QUEUE)
    tr = pre + "transformer."
    specs.append((pre + "bev_embedding.weight", (bev["bev_h"] * bev["bev_w"], C),
                  ("normal", 1.0)))
    specs.append((pre + "query_embedding.weight", (h["num_query"], 2 * C),
                  ("normal", 1.0)))
    specs.append((pre + "positional_encoding.row_embed.weight",
                  (bev["bev_h"], C // 2), ("uniform", 0.0, 1.0)))
    specs.append((pre + "positional_encoding.col_embed.weight",
                  (bev["bev_w"], C // 2), ("uniform", 0.0, 1.0)))
    specs.append((tr + "level_embeds", (L, C), ("normal", 1.0)))
    specs.append((tr + "cams_embeds", (N, C), ("normal", 1.0)))
    _linear(specs, tr + "reference_points", 3, C, init=_xavier(3, C))
    _linear(specs, tr + "can_bus_mlp.0", C // 2, CAN_BUS_DIMS)
    _linear(specs, tr + "can_bus_mlp.2", C, C // 2)
    _ln(specs, tr + "can_bus_mlp.norm", C)
    for i in range(bev["num_encoder_layers"]):
        p = f"{tr}encoder.layers.{i}."
        t = p + "attentions.0."
        _linear(specs, t + "sampling_offsets", nq * nh * Pt * 2, nq * C,
                bias_init=("values", grid_bias(nh, nq, Pt)))
        _linear(specs, t + "attention_weights", nq * nh * Pt, nq * C)
        _linear(specs, t + "value_proj", C, C, init=_xavier(C, C))
        _linear(specs, t + "output_proj", C, C, init=_xavier(C, C))
        s = p + "attentions.1."
        _linear(specs, s + "deformable_attention.sampling_offsets",
                nh * L * Ps * 2, C, bias_init=("values", grid_bias(nh, L, Ps)))
        _linear(specs, s + "deformable_attention.attention_weights",
                nh * L * Ps, C)
        _linear(specs, s + "deformable_attention.value_proj", C, C,
                init=_xavier(C, C))
        _linear(specs, s + "output_proj", C, C, init=_xavier(C, C))
        _linear(specs, p + "ffns.0.layers.0.0", h["ffn_dims"], C)
        _linear(specs, p + "ffns.0.layers.1", C, h["ffn_dims"])
        for j in range(3):
            _ln(specs, f"{p}norms.{j}", C)

    def cross(specs, p):
        _linear(specs, p + "sampling_offsets", nh * Pd * 2, C,
                bias_init=("values", grid_bias(nh, 1, Pd)))
        _linear(specs, p + "attention_weights", nh * Pd, C)
        _linear(specs, p + "value_proj", C, C, init=_xavier(C, C))
        _linear(specs, p + "output_proj", C, C, init=_xavier(C, C))

    for i in range(h["num_decoder_layers"]):
        flagship.decoder_layer_specs(specs, f"{tr}decoder.layers.{i}.", h, cross)
    for i in range(h["num_decoder_layers"]):
        p = f"{pre}cls_branches.{i}."
        _linear(specs, p + "0", C, C)
        _ln(specs, p + "1", C)
        _linear(specs, p + "3", C, C)
        _ln(specs, p + "4", C)
        _linear(specs, p + "6", h["num_classes"], C,
                bias_init=("const", CLS_PRIOR_BIAS))
    for i in range(h["num_decoder_layers"]):
        p = f"{pre}reg_branches.{i}."
        _linear(specs, p + "0", C, C)
        _linear(specs, p + "2", C, C)
        _linear(specs, p + "4", h["code_size"], C,
                init=("normal", REG_OUT_SCALE / math.sqrt(C)))


def param_specs(model: dict):
    """[(reference name, shape, init)] of every tensor of the state dict
    (reference/flagship.py's kinds of init), the DCN offset convs'
    weights at OFFSET_WEIGHT_SCALE of flagship.py's."""
    specs = []
    flagship.resnet_specs(specs, "img_backbone.", model["backbone"])
    specs[:] = [(n, s, ("normal", i[1] * OFFSET_WEIGHT_SCALE)
                 if n.endswith(".conv_offset.weight") else i)
                for n, s, i in specs]
    flagship.fpn_specs(specs, "img_neck.", model["neck"])
    head_specs(specs, "pts_bbox_head.", model)
    return specs


# --------------------------------------------------------------- forward
def resnet_caffe(ref, x, prefix, b):
    """mmdet's ResNet, style='caffe': each stage's first bottleneck
    strides on its 1x1 conv1 and downsample; every 3x3 (DCN or not) runs
    at stride 1. x (B, H, W, 3) -> the outputs of stages out_indices."""
    x = torch.relu(ref.frozen_bn(ref.conv(x, prefix + "conv1", 2, 3),
                                 prefix + "bn1"))
    x = torch.nn.functional.max_pool2d(
        x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)
    outs = []
    for stage, blocks in enumerate(STAGE_BLOCKS[b["depth"]]):
        dcn = b["use_dcn"] and b["stage_with_dcn"][stage]
        for i in range(blocks):
            p = f"{prefix}layer{stage + 1}.{i}."
            stride = 2 if (i == 0 and stage > 0) else 1
            y = torch.relu(ref.frozen_bn(ref.conv(x, p + "conv1", stride),
                                         p + "bn1"))
            y = (deform_conv(ref, y, p + "conv2", 1) if dcn
                 else ref.conv(y, p + "conv2", 1, 1))
            y = torch.relu(ref.frozen_bn(y, p + "bn2"))
            y = ref.frozen_bn(ref.conv(y, p + "conv3"), p + "bn3")
            if p + "downsample.0.weight" in ref.sd:
                x = ref.frozen_bn(ref.conv(x, p + "downsample.0", stride),
                                  p + "downsample.1")
            x = torch.relu(y + x)
        if stage in b["out_indices"]:
            outs.append(x)
    return outs


def features(ref, model, images):
    """images (B, N, H, W, 3) normalised -> L x (B, N, h, w, C)."""
    B, N, H, W, _ = images.shape
    x = images.reshape(B * N, H, W, 3).float()
    outs = fpn(ref, resnet_caffe(ref, x, "img_backbone.", model["backbone"]),
               "img_neck.", model["neck"])
    return [f.reshape(B, N, *f.shape[1:]) for f in outs]


def shift_of(can_bus, bev):
    """(B, 2) shift (x, y) of the previous BEV's reference points
    (PerceptionTransformer.get_bev_features), float32."""
    pc = bev["pc_range"]
    gy, gx = (pc[4] - pc[1]) / bev["bev_h"], (pc[3] - pc[0]) / bev["bev_w"]
    dx, dy = can_bus[:, 0], can_bus[:, 1]
    ego = can_bus[:, CAN_YAW_RAD] / math.pi * 180
    length = torch.sqrt(dx * dx + dy * dy)
    angle = torch.atan2(dy, dx) / math.pi * 180
    bev_angle = (ego - angle) / 180 * math.pi
    shift_y = length * torch.cos(bev_angle) / gy / bev["bev_h"]
    shift_x = length * torch.sin(bev_angle) / gx / bev["bev_w"]
    return torch.stack([shift_x, shift_y], dim=-1)


def rotate(bev_map, angle_deg, bh, bw):
    """torchvision.transforms.functional.rotate(img, angle, center=map
    centre) of bev_map (B, H * W, C): the inverse affine grid of
    _get_inverse_affine_matrix(centre, -angle) over the pixel centres,
    normalised by half the size, sampled by grid_sample (nearest, zeros,
    align_corners False)."""
    B, _, C = bev_map.shape
    dev = bev_map.device
    rot = -angle_deg / 180 * math.pi
    cos, sin = torch.cos(rot)[:, None, None], torch.sin(rot)[:, None, None]
    xs = torch.linspace(-bw * 0.5 + 0.5, bw * 0.5 - 0.5, bw, device=dev)[None, None, :]
    ys = torch.linspace(-bh * 0.5 + 0.5, bh * 0.5 - 0.5, bh, device=dev)[None, :, None]
    grid = torch.stack([(cos * xs + sin * ys) / (0.5 * bw),
                        (cos * ys - sin * xs) / (0.5 * bh)], dim=-1)
    img = bev_map.view(B, bh, bw, C).permute(0, 3, 1, 2)
    out = torch.nn.functional.grid_sample(img, grid, mode="nearest",
                                          padding_mode="zeros",
                                          align_corners=False)
    return out.permute(0, 2, 3, 1).reshape(B, bh * bw, C)


def cell_centres(bh, bw, dev):
    ys = torch.linspace(0.5, bh - 0.5, bh, device=dev) / bh
    xs = torch.linspace(0.5, bw - 0.5, bw, device=dev) / bw
    ry, rx = torch.meshgrid(ys, xs, indexing="ij")
    return rx.reshape(-1), ry.reshape(-1)


def point_sampling(model, lidar2img, dev):
    """The pillars' projections (B, N, Q, D, 2) in [0, 1] of the padded
    image and their mask (B, N, Q, D) (BEVFormerEncoder.point_sampling)."""
    h, bev = model["head"], model["bev"]
    pc = h["pc_range"]
    D = bev["num_points_in_pillar"]
    Z = pc[5] - pc[2]
    zs = torch.linspace(0.5, Z - 0.5, D, device=dev) / Z
    rx, ry = cell_centres(bev["bev_h"], bev["bev_w"], dev)
    Q = rx.shape[0]
    pts = torch.stack([rx[:, None].expand(Q, D) * (pc[3] - pc[0]) + pc[0],
                       ry[:, None].expand(Q, D) * (pc[4] - pc[1]) + pc[1],
                       zs[None, :].expand(Q, D) * Z + pc[2],
                       torch.ones(Q, D, device=dev)], dim=-1)
    cam = torch.einsum("bnij,qdj->bnqdi", lidar2img.float(), pts)
    eps = 1e-5
    z = cam[..., 2:3]
    img_h, img_w = model["img_size"]
    uv = cam[..., 0:2] / torch.maximum(z, torch.ones_like(z) * eps)
    uv = uv / torch.tensor([img_w, img_h], dtype=torch.float32, device=dev)
    mask = ((z > eps) & (uv[..., 1:2] > 0.0) & (uv[..., 1:2] < 1.0)
            & (uv[..., 0:1] < 1.0) & (uv[..., 0:1] > 0.0))[..., 0]
    return uv, mask


def tsa(ref, p, model, query, query_pos, value2, ref2):
    """TemporalSelfAttention: value2 (B, 2, Q, C), ref2 (B, 2, Q, 2)."""
    h, bev = model["head"], model["bev"]
    B, Q, C = query.shape
    nh, P, nq = h["num_heads"], bev["tsa_num_points"], NUM_BEV_QUEUE
    bh, bw = bev["bev_h"], bev["bev_w"]
    q = torch.cat([value2[:, 0], query + query_pos], dim=-1)
    off = ref.linear(q, p + "sampling_offsets").view(B, Q, nh, nq, 1, P, 2)
    off = off.permute(0, 3, 1, 2, 4, 5, 6)
    attn = torch.softmax(ref.linear(q, p + "attention_weights")
                         .view(B, Q, nh, nq, P), dim=-1).permute(0, 3, 1, 2, 4)
    wh = torch.tensor([bw, bh], dtype=torch.float32, device=query.device)
    loc = ref2[:, :, :, None, None, None, :] + off / wh
    v = ref.linear(value2, p + "value_proj").reshape(B * nq, Q, nh, C // nh)
    out = msda(v, [(bh, bw)], loc.reshape(B * nq, Q, nh, 1, P, 2),
               attn.reshape(B * nq, Q, nh, 1, P))
    out = out.view(B, nq, Q, C).mean(dim=1)
    return query + ref.linear(out, p + "output_proj")


def index_lists(mask):
    """Each camera's queries with any in-view height, (B, N) lists; every
    query on the meta device, which holds no mask."""
    B, N, Q, _ = mask.shape
    if mask.device.type == "meta":
        return [[torch.arange(Q, device=mask.device) for _ in range(N)]
                for _ in range(B)]
    return [[mask[b, n].any(-1).nonzero().squeeze(-1) for n in range(N)]
            for b in range(B)]


def sca(ref, p, model, query, query_pos, value, shapes, uv, mask, lists):
    """SpatialCrossAttention with MSDeformableAttention3D: value (B, N, S,
    C), uv (B, N, Q, D, 2), mask (B, N, Q, D), lists the index lists."""
    h, bev = model["head"], model["bev"]
    B, Q, C = query.shape
    N = value.shape[1]
    nh, L, P, D = (h["num_heads"], h["num_levels"], bev["sca_num_points"],
                   bev["num_points_in_pillar"])
    da = p + "deformable_attention."
    q = query + query_pos
    off = ref.linear(q, da + "sampling_offsets").view(B, Q, nh, L, P // D, D, 2)
    attn = torch.softmax(ref.linear(q, da + "attention_weights")
                         .view(B, Q, nh, L * P), dim=-1).view(B, Q, nh, L, P)
    max_len = max(len(i) for row in lists for i in row)
    loc = torch.zeros(B, N, max_len, nh, L, P // D, D, 2, device=query.device)
    att = torch.zeros(B, N, max_len, nh, L, P, device=query.device)
    wh = torch.tensor([[w, hh] for hh, w in shapes], dtype=torch.float32,
                      device=query.device)[:, None, None, :]
    for b in range(B):
        for n in range(N):
            idx = lists[b][n]
            k = len(idx)
            loc[b, n, :k] = (uv[b, n, idx][:, None, None, None, :, :]
                             + off[b, idx] / wh)
            att[b, n, :k] = attn[b, idx]
    v = ref.linear(value, da + "value_proj").reshape(B * N, -1, nh, C // nh)
    out = msda(v, shapes, loc.reshape(B * N, max_len, nh, L, P, 2),
               att.reshape(B * N, max_len, nh, L, P)).view(B, N, max_len, C)
    slots = torch.zeros(B, Q, C, device=query.device)
    for b in range(B):
        for n in range(N):
            idx = lists[b][n]
            slots[b, idx] += out[b, n, :len(idx)]
    count = mask.any(-1).sum(1).clamp(min=1).float()  # (B, Q)
    return query + ref.linear(slots / count[..., None], p + "output_proj")


def encoder(ref, model, feats, lidar2img, can_bus, prev_bev):
    """The BEV of a frame: feats L x (B, N, h, w, C), lidar2img (B, N,
    4, 4), can_bus (B, 18) the frame's motion (zero deltas on a scene's
    first frame), prev_bev (B, H * W, C) or None -> (B, H * W, C)."""
    h, bev = model["head"], dict(model["bev"], pc_range=model["head"]["pc_range"])
    B, N = feats[0].shape[:2]
    C, bh, bw = h["embed_dims"], bev["bev_h"], bev["bev_w"]
    dev = feats[0].device
    pre = "pts_bbox_head."
    tr = pre + "transformer."
    values, shapes = [], []
    for lvl, f in enumerate(feats):
        _, _, H, W, _ = f.shape
        values.append(f.float().reshape(B, N, H * W, C)
                      + ref.p(tr + "cams_embeds")[None, :, None]
                      + ref.p(tr + "level_embeds")[lvl])
        shapes.append((H, W))
    value = torch.cat(values, dim=2)
    can_bus = can_bus.float()
    x = torch.relu(ref.linear(can_bus, tr + "can_bus_mlp.0"))
    x = ref.layer_norm(torch.relu(ref.linear(x, tr + "can_bus_mlp.2")),
                       tr + "can_bus_mlp.norm")
    query = ref.p(pre + "bev_embedding.weight")[None] + x[:, None]
    row = ref.p(pre + "positional_encoding.row_embed.weight")
    col = ref.p(pre + "positional_encoding.col_embed.weight")
    bev_pos = torch.cat([col[None, :, :].expand(bh, bw, -1),
                         row[:, None, :].expand(bh, bw, -1)],
                        dim=-1).reshape(1, bh * bw, C).expand(B, -1, -1)
    rx, ry = cell_centres(bh, bw, dev)
    ref_2d = torch.stack([rx, ry], dim=-1)[None].expand(B, -1, -1)
    if prev_bev is None:
        value2 = None
        ref2 = torch.stack([ref_2d, ref_2d], dim=1)
    else:
        prev = rotate(prev_bev.float(), can_bus[:, CAN_YAW_DEG], bh, bw)
        value2 = torch.stack([prev, query], dim=1)
        ref2 = torch.stack([ref_2d + shift_of(can_bus, bev)[:, None], ref_2d],
                           dim=1)
    uv, mask = point_sampling(model, lidar2img, dev)
    lists = index_lists(mask)
    for i in range(bev["num_encoder_layers"]):
        p = f"{tr}encoder.layers.{i}."
        v2 = torch.stack([query, query], dim=1) if value2 is None else value2
        query = ref.layer_norm(tsa(ref, p + "attentions.0.", model, query,
                                   bev_pos, v2, ref2), p + "norms.0")
        query = ref.layer_norm(sca(ref, p + "attentions.1.", model, query,
                                   bev_pos, value, shapes, uv, mask, lists),
                               p + "norms.1")
        query = ref.layer_norm(ref.ffn(query, p + "ffns.0"), p + "norms.2")
    return query


def decoder(ref, model, bev_embed):
    """Every decoder layer's class logits (layers, B, Q, classes) and box
    codes (layers, B, Q, 10) over the BEV (B, H * W, C)."""
    h, bev = model["head"], model["bev"]
    B = bev_embed.shape[0]
    C, nh, P = h["embed_dims"], h["num_heads"], h["num_points"]
    bh, bw = bev["bev_h"], bev["bev_w"]
    pre = "pts_bbox_head."
    table = ref.p(pre + "query_embedding.weight")
    query_pos = table[None, :, :C].expand(B, -1, -1)
    query = table[None, :, C:].expand(B, -1, -1)
    Q = query.shape[1]
    ref_pts = torch.sigmoid(ref.linear(query_pos, pre + "transformer.reference_points"))
    pc = h["pc_range"]
    wh = torch.tensor([bw, bh], dtype=torch.float32, device=bev_embed.device)
    cls_all, box_all = [], []
    for lid in range(h["num_decoder_layers"]):
        p = f"{pre}transformer.decoder.layers.{lid}."
        qk = query + query_pos
        query = ref.layer_norm(
            query + ref.mha(qk, qk, query, p + "attentions.0.attn", nh),
            p + "norms.0")
        a = p + "attentions.1."
        q = query + query_pos
        off = ref.linear(q, a + "sampling_offsets").view(B, Q, nh, 1, P, 2)
        attn = torch.softmax(ref.linear(q, a + "attention_weights")
                             .view(B, Q, nh, P), dim=-1).view(B, Q, nh, 1, P)
        loc = ref_pts[:, :, None, None, None, :2] + off / wh
        v = ref.linear(bev_embed.float(), a + "value_proj").view(B, bh * bw, nh,
                                                                 C // nh)
        out = msda(v, [(bh, bw)], loc, attn)
        query = ref.layer_norm(query + ref.linear(out, a + "output_proj"),
                               p + "norms.1")
        query = ref.layer_norm(ref.ffn(query, p + "ffns.0"), p + "norms.2")

        c = f"{pre}cls_branches.{lid}."
        x = query
        for i in (0, 3):
            x = torch.relu(ref.layer_norm(ref.linear(x, c + str(i)), c + str(i + 1)))
        cls_all.append(ref.linear(x, c + "6"))
        r = f"{pre}reg_branches.{lid}."
        t = torch.relu(ref.linear(torch.relu(ref.linear(query, r + "0")), r + "2"))
        t = ref.linear(t, r + "4")
        ris = inverse_sigmoid(ref_pts)
        xy = torch.sigmoid(t[..., 0:2] + ris[..., 0:2])
        z = torch.sigmoid(t[..., 4:5] + ris[..., 2:3])
        box_all.append(torch.cat([
            xy[..., 0:1] * (pc[3] - pc[0]) + pc[0],
            xy[..., 1:2] * (pc[4] - pc[1]) + pc[1], t[..., 2:4],
            z * (pc[5] - pc[2]) + pc[2], t[..., 5:]], dim=-1))
        ref_pts = torch.cat([xy, z], dim=-1)
    return torch.stack(cls_all), torch.stack(box_all)


def bev_forward(ref, model, feats, lidar2img, can_bus, prev_bev):
    """(bev (B, H * W, C), cls, box) of one frame."""
    bev_embed = encoder(ref, model, feats, lidar2img, can_bus, prev_bev)
    cls, box = decoder(ref, model, bev_embed)
    return bev_embed, cls, box


def forward_feats(ref, model, feats, lidar2img, extras):
    """(cls, box) of one frame; extras may hold `can_bus` (B, 18), the
    frame's motion (absent: a scene's first frame, zero), and `prev_bev`
    (absent: none)."""
    B = feats[0].shape[0]
    can_bus = extras.get("can_bus")
    if can_bus is None or can_bus.dim() != 2:
        can_bus = torch.zeros(B, CAN_BUS_DIMS, device=feats[0].device)
    return bev_forward(ref, model, feats, lidar2img, can_bus,
                       extras.get("prev_bev"))[1:]
