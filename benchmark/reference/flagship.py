"""Plain float32 reference of Graph-DETR4D's flagship
(detr4d_res50_deform_pe_testaug_2subset_12e): ResNet-50 with modulated
deformable convolutions (DCNv2) on stages 3-4 and frozen BN, an FPN with
one extra output, and Detr3DHeadPE (the PETR-style 3D position embedding
with its SE gate and the 3-axis sine embedding, 6 post-norm decoder
layers whose cross-attention is the graph 3D deformable attention,
iterative box refinement).

Written from the reference repository's description
(projects/mmdet3d_plugin/models/dense_heads/detr3d_head_pe.py,
utils/deform3d_cross_attn.py, mmcv's ModulatedDeformConv2d and mmdet's
ResNet and FPN) with the weights' reference names. Departures from the
measured program, each exact in real arithmetic:

  * the cross-attention samples every query in every camera; the program
    samples only each camera's first ceil(Q cam_capacity) queries that
    have an in-view sample, which is the same sum while no camera has
    more (the program's `cam_overflow` is then 0, and the benchmark checks
    that it is);
  * everything is float32 with TF32 off; the program computes in
    bfloat16 with float32 softmax, gate, projections and decode.

`model` is the configuration file's "model" object: the program's
configuration with every field, read here by name.
"""

import math

import numpy as np
import torch

from .common import (bilinear, coords_3d, inverse_sigmoid, lid_bins,
                     sine_pe_3d)

CLS_PRIOR_BIAS = -math.log((1.0 - 0.01) / 0.01)
REG_OUT_SCALE = 0.1
STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


# ------------------------------------------------------------ parameters
def _conv(specs, name, cout, cin, k, bias=False, std=None, bias_std=None):
    specs.append((name + ".weight", (cout, cin, k, k),
                  ("normal", std if std is not None else 1 / math.sqrt(cin * k * k))))
    if bias:
        specs.append((name + ".bias", (cout,),
                      ("normal", bias_std) if bias_std else ("const", 0.0)))


def _linear(specs, name, cout, cin, init=None, bias_init=("const", 0.0)):
    specs.append((name + ".weight", (cout, cin),
                  init or ("normal", 1 / math.sqrt(cin))))
    specs.append((name + ".bias", (cout,), bias_init))


def _pointwise(specs, name, cout, cin):
    specs.append((name + ".weight", (cout, cin, 1, 1),
                  ("normal", 1 / math.sqrt(cin))))
    specs.append((name + ".bias", (cout,), ("const", 0.0)))


def _bn(specs, name, n):
    """Frozen BN statistics drawn so that they vary: weight and variance
    in [0.5, 1.5), bias and mean in [-0.2, 0.2)."""
    specs += [(name + ".weight", (n,), ("uniform", 0.5, 1.5)),
              (name + ".bias", (n,), ("uniform", -0.2, 0.2)),
              (name + ".running_mean", (n,), ("uniform", -0.2, 0.2)),
              (name + ".running_var", (n,), ("uniform", 0.5, 1.5))]


def _ln(specs, name, n):
    specs += [(name + ".weight", (n,), ("const", 1.0)),
              (name + ".bias", (n,), ("const", 0.0))]


def mha_specs(specs, p, C):
    """A packed multi-head attention: in_proj_weight (3C, C) at
    1/sqrt(C), zero in_proj_bias, out_proj."""
    specs += [(p + ".in_proj_weight", (3 * C, C), ("normal", 1 / math.sqrt(C))),
              (p + ".in_proj_bias", (3 * C,), ("const", 0.0))]
    _linear(specs, p + ".out_proj", C, C)


def _xavier(cout, cin):
    a = math.sqrt(6.0 / (cout + cin))
    return ("uniform", -a, a)


def offset_bias(num_heads, num_points):
    """The circular-cone 3D offset bias of the sampling offsets
    (deform3d_cross_attn.py:138-148), flattened (heads, 1, points, 3)."""
    th = np.arange(num_heads, dtype=np.float32) * (2.0 * math.pi / num_heads)
    grid = np.stack([np.cos(th), np.sin(th), np.cos(th)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, 1, num_points, 1))
    grid = grid * np.arange(1, num_points + 1, dtype=np.float32)[None, None, :, None]
    return tuple(float(v) for v in grid.reshape(-1))


def resnet_specs(specs, prefix, b):
    depth = b["depth"]
    _conv(specs, prefix + "conv1", 64, 3, 7)
    _bn(specs, prefix + "bn1", 64)
    cin, width = 64, 64
    for stage, blocks in enumerate(STAGE_BLOCKS[depth]):
        dcn = b["use_dcn"] and b["stage_with_dcn"][stage]
        for i in range(blocks):
            p = f"{prefix}layer{stage + 1}.{i}."
            stride = 2 if (i == 0 and stage > 0) else 1
            _conv(specs, p + "conv1", width, cin, 1)
            _bn(specs, p + "bn1", width)
            if dcn:
                _conv(specs, p + "conv2", width, width, 3,
                      std=math.sqrt(2.0 / (width * 9)))
                _conv(specs, p + "conv2.conv_offset", 27, width, 3, bias=True,
                      bias_std=0.5)
            else:
                _conv(specs, p + "conv2", width, width, 3)
            _bn(specs, p + "bn2", width)
            _conv(specs, p + "conv3", width * 4, width, 1)
            _bn(specs, p + "bn3", width * 4)
            if stride != 1 or cin != width * 4:
                _conv(specs, p + "downsample.0", width * 4, cin, 1)
                _bn(specs, p + "downsample.1", width * 4)
            cin = width * 4
        width *= 2


def fpn_specs(specs, prefix, n):
    used = list(n["in_channels"][n["start_level"]:])
    C = n["out_channels"]
    for i, c in enumerate(used):
        _conv(specs, f"{prefix}lateral_convs.{i}.conv", C, c, 1, bias=True)
    convs = 1 if n["cp"] else len(used)
    for i in range(convs + n["num_outs"] - len(used)):
        _conv(specs, f"{prefix}fpn_convs.{i}.conv", C, C, 3, bias=True)


def decoder_layer_specs(specs, p, h, cross):
    C = h["embed_dims"]
    mha_specs(specs, p + "attentions.0.attn", C)
    cross(specs, p + "attentions.1.")
    _linear(specs, p + "ffns.0.layers.0.0", h["ffn_dims"], C)
    _linear(specs, p + "ffns.0.layers.1", C, h["ffn_dims"])
    for i in range(3):
        _ln(specs, f"{p}norms.{i}", C)


def head_specs(specs, prefix, h):
    C, nh, L, P, N = (h["embed_dims"], h["num_heads"], h["num_levels"],
                      h["num_points"], h["num_cams"])

    def cross(specs, p):
        _linear(specs, p + "cam_attention_weights", N, C)
        _linear(specs, p + "deform_sampling_offsets", nh * P * 3, C,
                bias_init=("values", offset_bias(nh, P)))
        _linear(specs, p + "attention_weights", nh * L * P, C)
        _linear(specs, p + "value_proj", C, C, init=_xavier(C, C))
        _linear(specs, p + "output_proj", C, C, init=_xavier(C, C))
        _linear(specs, p + "position_encoder.0", C, 3)
        _ln(specs, p + "position_encoder.1", C)
        _linear(specs, p + "position_encoder.3", C, C)
        _ln(specs, p + "position_encoder.4", C)

    specs.append((prefix + "query_embedding.weight", (h["num_query"], 2 * C),
                  ("normal", 1.0)))
    _linear(specs, prefix + "transformer.reference_points", 3, C,
            init=_xavier(3, C))
    for i in range(h["num_decoder_layers"]):
        decoder_layer_specs(specs, f"{prefix}transformer.decoder.layers.{i}.",
                            h, cross)
    _pointwise(specs, prefix + "position_encoder.0", 4 * C, h["depth_num"] * 3)
    _pointwise(specs, prefix + "position_encoder.2", C, 4 * C)
    _pointwise(specs, prefix + "adapt_pos3d.0", 4 * C, h["pe_num_feats"] * 3)
    _pointwise(specs, prefix + "adapt_pos3d.2", C, 4 * C)
    _pointwise(specs, prefix + "fpe.conv_reduce", C, C)
    _pointwise(specs, prefix + "fpe.conv_expand", C, C)
    for i in range(h["num_decoder_layers"]):
        p = f"{prefix}cls_branches.{i}."
        _linear(specs, p + "0", C, C)
        _ln(specs, p + "1", C)
        _linear(specs, p + "3", C, C)
        _ln(specs, p + "4", C)
        _linear(specs, p + "6", h["num_classes"], C,
                bias_init=("const", CLS_PRIOR_BIAS))
    for i in range(h["num_decoder_layers"]):
        p = f"{prefix}reg_branches.{i}."
        _linear(specs, p + "0", C, C)
        _linear(specs, p + "2", C, C)
        _linear(specs, p + "4", h["code_size"], C,
                init=("normal", REG_OUT_SCALE / math.sqrt(C)))


def param_specs(model: dict):
    """[(reference name, shape, init)] of every tensor of the state dict,
    in the program's order; init is ("normal", std), ("uniform", lo,
    hi), ("const", v) or ("values", tuple)."""
    specs = []
    resnet_specs(specs, "img_backbone.", model["backbone"])
    fpn_specs(specs, "img_neck.", model["neck"])
    head_specs(specs, "pts_bbox_head.", model["head"])
    return specs


# --------------------------------------------------------------- forward
def deform_conv(ref, x, prefix, stride):
    """DCNv2 3x3 (padding 1, no bias): the offset conv gives 9 (dy, dx)
    pairs then 9 mask logits per output pixel; each tap samples x at
    (y s - 1 + ky + dy, x s - 1 + kx + dx) bilinearly, scaled by
    sigmoid(mask), and the taps meet the weight in one product."""
    om = ref.conv(x, prefix + ".conv_offset", stride, 1, bias=True)
    B, Ho, Wo, _ = om.shape
    off = om[..., :18].reshape(B, Ho, Wo, 9, 2)
    mask = torch.sigmoid(om[..., 18:])
    dev = x.device
    k = torch.arange(9, device=dev)
    py = ((torch.arange(Ho, device=dev) * stride - 1)[None, :, None, None]
          + (k // 3) + off[..., 0])
    px = ((torch.arange(Wo, device=dev) * stride - 1)[None, None, :, None]
          + (k % 3) + off[..., 1])
    cols = bilinear(x, py, px) * mask[..., None]  # (B, Ho, Wo, 9, Cin)
    w = ref.p(prefix + ".weight")
    Cout, Cin = w.shape[:2]
    w = w.permute(2, 3, 1, 0).reshape(9 * Cin, Cout)
    out = torch.matmul(ref.q(cols.reshape(-1, 9 * Cin)), ref.q(w))
    return out.view(B, Ho, Wo, Cout)


def resnet(ref, x, prefix, b):
    """x (B, H, W, 3) -> the outputs of stages out_indices, channels-last."""
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
            y = torch.relu(ref.frozen_bn(ref.conv(x, p + "conv1"), p + "bn1"))
            y = (deform_conv(ref, y, p + "conv2", stride) if dcn
                 else ref.conv(y, p + "conv2", stride, 1))
            y = torch.relu(ref.frozen_bn(y, p + "bn2"))
            y = ref.frozen_bn(ref.conv(y, p + "conv3"), p + "bn3")
            if p + "downsample.0.weight" in ref.sd:
                x = ref.frozen_bn(ref.conv(x, p + "downsample.0", stride),
                                  p + "downsample.1")
            x = torch.relu(y + x)
        if stage in b["out_indices"]:
            outs.append(x)
    return outs


def fpn(ref, inputs, prefix, n):
    """mmdet's FPN (nearest top-down, 'on_output' extra convs, relu before
    every extra conv but the first) or, with cp, CPFPN (the 3x3 output
    conv on level 0 only)."""
    used = list(inputs[n["start_level"]:])
    lat = [ref.conv(x, f"{prefix}lateral_convs.{i}.conv", bias=True)
           for i, x in enumerate(used)]
    for i in range(len(lat) - 1, 0, -1):
        H, W = lat[i - 1].shape[1:3]
        up = lat[i].repeat_interleave(H // lat[i].shape[1], 1)
        up = up.repeat_interleave(W // lat[i].shape[2], 2)
        lat[i - 1] = lat[i - 1] + up[:, :H, :W]
    convs = 1 if n["cp"] else len(lat)
    outs = [ref.conv(x, f"{prefix}fpn_convs.{i}.conv", 1, 1, bias=True)
            if i < convs else x for i, x in enumerate(lat)]
    for i in range(len(lat), n["num_outs"]):
        src = outs[-1]
        if n["relu_before_extra_convs"] and i > len(lat):
            src = torch.relu(src)
        outs.append(ref.conv(src, f"{prefix}fpn_convs.{convs + i - len(lat)}.conv",
                             2, 1, bias=True))
    return outs


def features(ref, model, images):
    """images (B, N, H, W, 3) normalised -> L x (B, N, h, w, C)."""
    B, N, H, W, _ = images.shape
    x = images.reshape(B * N, H, W, 3).float()
    outs = fpn(ref, resnet(ref, x, "img_backbone.", model["backbone"]),
               "img_neck.", model["neck"])
    return [f.reshape(B, N, *f.shape[1:]) for f in outs]


def msda(value, shapes, loc, attn):
    """Multi-scale deformable attention: value (BN, S, heads, hd) with the
    levels flattened in order, loc (BN, Q, heads, L, P, 2) as (x, y) in
    [0, 1] of each level (pixel x W - 0.5), attn (BN, Q, heads, L, P) ->
    (BN, Q, heads * hd)."""
    BN, S, nh, hd = value.shape
    Q = loc.shape[1]
    out = torch.zeros(BN, nh, Q, hd, device=value.device)
    start = 0
    for lvl, (H, W) in enumerate(shapes):
        v = value[:, start:start + H * W].permute(0, 2, 1, 3)
        v = v.reshape(BN * nh, H, W, hd)
        lc = loc[:, :, :, lvl].permute(0, 2, 1, 3, 4)  # (BN, nh, Q, P, 2)
        px = lc[..., 0].reshape(BN * nh, -1) * W - 0.5
        py = lc[..., 1].reshape(BN * nh, -1) * H - 0.5
        s = bilinear(v, py, px).view(BN, nh, Q, -1, hd)
        a = attn[:, :, :, lvl].permute(0, 2, 1, 3)  # (BN, nh, Q, P)
        out += (s * a[..., None]).sum(3)
        start += H * W
    return out.permute(0, 2, 1, 3).reshape(BN, Q, nh * hd)


def cross_attention(ref, p, h, query, query_pos, value, shapes, ref_pts,
                    lidar2img, img_shape):
    """The graph 3D deformable cross-attention over every query and camera."""
    B, Q, C = query.shape
    nh, L, P, N = (h["num_heads"], h["num_levels"], h["num_points"],
                   h["num_cams"])
    pc = torch.tensor(h["pc_range"], device=query.device)
    q = query + query_pos
    gate_logits = ref.linear(q, p + "cam_attention_weights")  # (B, Q, N)
    offsets = ref.linear(q, p + "deform_sampling_offsets").view(B, Q, nh, 1, P, 3)
    metric = ref_pts * (pc[3:] - pc[:3]) + pc[:3]
    pts = metric[:, :, None, None, None, :] + offsets.expand(B, Q, nh, L, P, 3)
    hom = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    cam = torch.einsum("bnij,bqhlpj->bnqhlpi", lidar2img, hom)
    eps = 1e-5
    z = cam[..., 2:3]
    img_h, img_w = img_shape
    loc = cam[..., 0:2] / z.clamp(min=eps) / torch.tensor(
        [img_w, img_h], dtype=torch.float32, device=query.device)
    valid = ((z > eps) & (loc[..., 0:1] > 0) & (loc[..., 0:1] < 1)
             & (loc[..., 1:2] > 0) & (loc[..., 1:2] < 1))[..., 0].float()
    attn = torch.softmax(ref.linear(q, p + "attention_weights")
                         .view(B, Q, nh, L * P), dim=-1)
    attn = attn.view(B, 1, Q, nh, L, P) * valid
    v = ref.linear(value, p + "value_proj").reshape(B * N, -1, nh, C // nh)
    sampled = msda(v, shapes, loc.reshape(B * N, Q, nh, L, P, 2),
                   attn.reshape(B * N, Q, nh, L, P)).view(B, N, Q, C)
    # the reference's gate: the (B, Q, N) sigmoid read as (B, N, Q) by a
    # memory reinterpretation, not a transpose (deform3d_cross_attn.py:211)
    gate = torch.sigmoid(gate_logits).reshape(B, N, Q, 1)
    out = ref.linear((sampled * gate).sum(1), p + "output_proj")
    pos = inverse_sigmoid(ref_pts)
    for i in (0, 3):
        pos = torch.relu(ref.layer_norm(ref.linear(pos, f"{p}position_encoder.{i}"),
                                        f"{p}position_encoder.{i + 1}"))
    return out + query + pos


def head(ref, model, feats, lidar2img):
    """Detr3DHeadPE over L x (B, N, h, w, C) features: every decoder
    layer's class logits (layers, B, Q, classes) and box codes (layers,
    B, Q, 10) with the centre decoded, as the program returns them."""
    h = model["head"]
    img_shape = tuple(model["img_size"])
    pre = "pts_bbox_head."
    lidar2img = lidar2img.float()
    B, N = feats[0].shape[:2]
    C = h["embed_dims"]
    dev = feats[0].device
    depth = lid_bins(h["depth_num"], h["depth_start"], h["pc_range"][3], dev)
    values, shapes = [], []
    for f in feats:
        f = f.float()
        _, _, H, W, _ = f.shape
        pe = ref.mlp2(coords_3d(lidar2img, H, W, img_shape, depth,
                                h["pc_range"]), pre + "position_encoder")
        pe = ref.se(pe, f, pre + "fpe")
        sin = sine_pe_3d(B, N, H, W, h["pe_num_feats"], -0.5, dev)
        pe = pe + ref.mlp2(sin, pre + "adapt_pos3d")
        values.append((f + pe).reshape(B, N, H * W, C))
        shapes.append((H, W))
    value = torch.cat(values, dim=2)

    table = ref.p(pre + "query_embedding.weight")
    query_pos = table[None, :, :C].expand(B, -1, -1)
    query = table[None, :, C:].expand(B, -1, -1)
    ref_pts = torch.sigmoid(ref.linear(query_pos, pre + "transformer.reference_points"))
    pc = h["pc_range"]
    cls_all, box_all = [], []
    for lid in range(h["num_decoder_layers"]):
        p = f"{pre}transformer.decoder.layers.{lid}."
        qk = query + query_pos
        query = ref.layer_norm(
            query + ref.mha(qk, qk, query, p + "attentions.0.attn", h["num_heads"]),
            p + "norms.0")
        query = ref.layer_norm(cross_attention(
            ref, p + "attentions.1.", h, query, query_pos, value, shapes,
            ref_pts, lidar2img, img_shape), p + "norms.1")
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


def forward_feats(ref, model, feats, lidar2img, extras):
    return head(ref, model, feats, lidar2img)
