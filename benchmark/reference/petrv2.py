"""Plain float32 reference of PETRv2 (petrv2_vovnet_gridmask_p4_1600x640):
VoVNet-99 with eSE and frozen BN, CPFPN over its last two stages, and
the PETRv2 head (a 1x1 input projection of level 0; the 3D coordinate
embedding over LID depth bins gated by an SE layer of the projected
features; the 3-axis sine embedding with offset 0; 6 post-norm decoder
layers of self-attention and dense cross-attention to every pixel of
every camera; a shared post-norm before each layer's branches; the
grouped regression branch; the velocity divided by mean_time_stamp).

Written from the reference repositories' description (PETR's
petrv2_head.py, petr_transformer.py, cp_fpn.py and VoVNet's vovnet.py)
with the weights' reference names, in float32 with TF32 off; the
program computes in bfloat16 with float32 attention logits and decode.
"""

import math

import torch

from .common import coords_3d, inverse_sigmoid, lid_bins, sine_pe_3d
from .flagship import (CLS_PRIOR_BIAS, REG_OUT_SCALE, _bn, _conv, _linear,
                       _ln, _pointwise, decoder_layer_specs, fpn, fpn_specs,
                       mha_specs)

VOVNET_99 = dict(stem=(64, 64, 128), stage_conv_ch=(128, 160, 192, 224),
                 stage_out_ch=(256, 512, 768, 1024), layer_per_block=5,
                 block_per_stage=(1, 3, 9, 3))
REG_GROUPS = (2, 1, 3, 2, 2)


def _osa_names(stage, block):
    return f"stage{stage + 2}.OSA{stage + 2}_{block + 1}"


def vovnet_specs(specs, prefix, spec):
    s1, s2, s3 = spec["stem"]
    for name, cin, cout in (("stem_1", 3, s1), ("stem_2", s1, s2),
                            ("stem_3", s2, s3)):
        _conv(specs, f"{prefix}stem.{name}/conv", cout, cin, 3)
        _bn(specs, f"{prefix}stem.{name}/norm", cout)
    cin = s3
    for stage in range(4):
        conv_ch, out_ch = spec["stage_conv_ch"][stage], spec["stage_out_ch"][stage]
        for b in range(spec["block_per_stage"][stage]):
            tag = f"OSA{stage + 2}_{b + 1}"
            p = f"{prefix}{_osa_names(stage, b)}."
            ch = cin
            for i in range(spec["layer_per_block"]):
                _conv(specs, f"{p}layers.{i}.{tag}_{i}/conv", conv_ch, ch, 3)
                _bn(specs, f"{p}layers.{i}.{tag}_{i}/norm", conv_ch)
                ch = conv_ch
            _conv(specs, f"{p}concat.{tag}_concat/conv", out_ch,
                  cin + spec["layer_per_block"] * conv_ch, 1)
            _bn(specs, f"{p}concat.{tag}_concat/norm", out_ch)
            _conv(specs, f"{p}ese.fc", out_ch, out_ch, 1, bias=True)
            cin = out_ch


def head_specs(specs, prefix, h, in_channels):
    C, L = h["embed_dims"], h["num_decoder_layers"]
    _pointwise(specs, prefix + "input_proj", C, in_channels)
    _pointwise(specs, prefix + "position_encoder.0", 4 * C, h["depth_num"] * 3)
    _pointwise(specs, prefix + "position_encoder.2", C, 4 * C)
    _pointwise(specs, prefix + "adapt_pos3d.0", 4 * C, h["pe_num_feats"] * 3)
    _pointwise(specs, prefix + "adapt_pos3d.2", C, 4 * C)
    _pointwise(specs, prefix + "fpe.conv_reduce", C, C)
    _pointwise(specs, prefix + "fpe.conv_expand", C, C)
    specs.append((prefix + "reference_points.weight", (h["num_query"], 3),
                  ("uniform", 0.0, 1.0)))
    _linear(specs, prefix + "query_embedding.0", C, h["pe_num_feats"] * 3)
    _linear(specs, prefix + "query_embedding.2", C, C)

    def cross(specs, p):
        mha_specs(specs, p + "attn", C)

    for i in range(L):
        decoder_layer_specs(specs, f"{prefix}transformer.decoder.layers.{i}.",
                            h, cross)
    _ln(specs, prefix + "transformer.decoder.post_norm", C)
    for i in range(L):
        p = f"{prefix}cls_branches.{i}."
        _linear(specs, p + "0", C, C)
        _ln(specs, p + "1", C)
        _linear(specs, p + "3", C, C)
        _ln(specs, p + "4", C)
        _linear(specs, p + "6", h["num_classes"], C,
                bias_init=("const", CLS_PRIOR_BIAS))
    for i in range(L):
        p = f"{prefix}reg_branches.{i}."
        _linear(specs, p + "reg_branch.0", C, C)
        _linear(specs, p + "reg_branch.3", C, C)
        for g, n in enumerate(REG_GROUPS):
            _linear(specs, f"{p}task_heads.{g}.0", C, C)
            _linear(specs, f"{p}task_heads.{g}.2", n, C,
                    init=("normal", REG_OUT_SCALE / math.sqrt(C)))


def param_specs(model: dict):
    """[(reference name, shape, init)], as flagship.param_specs."""
    if model["vovnet_spec"] != "V-99-eSE":
        raise ValueError(f"this reference is VoVNet V-99-eSE, not "
                         f"{model['vovnet_spec']}")
    specs = []
    vovnet_specs(specs, "img_backbone.", VOVNET_99)
    fpn_specs(specs, "img_neck.", model["neck"])
    head_specs(specs, "pts_bbox_head.", model["head"],
               model["neck"]["out_channels"])
    return specs


def _cbr(ref, x, name, stride=1, k=3):
    return torch.relu(ref.frozen_bn(ref.conv(x, name + "/conv", stride, k // 2),
                                    name + "/norm"))


def max_pool_ceil(x):
    """3x3 / 2 max pool without padding, ceil mode (channels-last)."""
    y = torch.nn.functional.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2,
                                       ceil_mode=True)
    return y.permute(0, 2, 3, 1)


def vovnet(ref, x, prefix, out_indices, spec=VOVNET_99):
    for name, stride in (("stem_1", 2), ("stem_2", 1), ("stem_3", 2)):
        x = _cbr(ref, x, f"{prefix}stem.{name}", stride)
    outs = []
    for stage in range(4):
        if stage > 0:
            x = max_pool_ceil(x)
        for b in range(spec["block_per_stage"][stage]):
            tag = f"OSA{stage + 2}_{b + 1}"
            p = f"{prefix}{_osa_names(stage, b)}."
            cat, y = [x], x
            for i in range(spec["layer_per_block"]):
                y = _cbr(ref, y, f"{p}layers.{i}.{tag}_{i}")
                cat.append(y)
            y = _cbr(ref, torch.cat(cat, dim=-1), f"{p}concat.{tag}_concat", k=1)
            s = ref.conv(y.mean(dim=(1, 2), keepdim=True), p + "ese.fc", bias=True)
            y = y * (torch.clamp(s + 3.0, 0.0, 6.0) / 6.0)
            x = y + x if b > 0 else y
        if stage in out_indices:
            outs.append(x)
    return outs


def features(ref, model, images):
    """images (B, N, H, W, 3) normalised -> L x (B, N, h, w, C)."""
    B, N, H, W, _ = images.shape
    x = images.reshape(B * N, H, W, 3).float()
    outs = fpn(ref, vovnet(ref, x, "img_backbone.", model["backbone"]["out_indices"]),
               "img_neck.", model["neck"])
    return [f.reshape(B, N, *f.shape[1:]) for f in outs]


def sine_embed(pos, num_feats, temperature=10000.0):
    """(..., 3) in [0, 1] -> (..., 3 F), per axis interleaved [sin(p0),
    cos(p1), sin(p2), ...]."""
    pos = pos * (2 * math.pi)
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * (dim_t // 2) / num_feats)
    outs = []
    for i in range(3):
        p = pos[..., i, None] / dim_t
        outs.append(torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()],
                                dim=-1).flatten(-2))
    return torch.cat(outs, dim=-1)


def head(ref, model, feats, lidar2img, mean_time_stamp):
    """The PETRv2 head over level 0: every decoder layer's class logits
    and box codes, as the program returns them."""
    h = model["head"]
    pre = "pts_bbox_head."
    f = feats[0].float()
    B, N, H, W, _ = f.shape
    C = h["embed_dims"]
    dev = f.device
    lidar2img = lidar2img.float()
    x = ref.linear(f, pre + "input_proj")
    depth = lid_bins(h["depth_num"], h["depth_start"],
                     h["petr_position_range"][3], dev)
    pos3d = ref.mlp2(coords_3d(lidar2img, H, W, tuple(model["img_size"]), depth,
                               h["petr_position_range"]), pre + "position_encoder")
    pos3d = ref.se(pos3d, x, pre + "fpe")
    sin = sine_pe_3d(B, N, H, W, h["pe_num_feats"], 0.0, dev)
    key_pos = (pos3d + ref.mlp2(sin, pre + "adapt_pos3d")).reshape(B, N * H * W, C)
    memory = x.reshape(B, N * H * W, C)

    rp = ref.p(pre + "reference_points.weight")
    query_pos = ref.linear(torch.relu(ref.linear(
        sine_embed(rp, h["pe_num_feats"]), pre + "query_embedding.0")),
        pre + "query_embedding.2")[None].expand(B, -1, -1)
    query = torch.zeros_like(query_pos)
    ris = inverse_sigmoid(rp)
    pc = h["pc_range"]
    nh = h["num_heads"]
    cls_all, box_all = [], []
    for lid in range(h["num_decoder_layers"]):
        p = f"{pre}transformer.decoder.layers.{lid}."
        qk = query + query_pos
        query = ref.layer_norm(
            query + ref.mha(qk, qk, query, p + "attentions.0.attn", nh), p + "norms.0")
        query = ref.layer_norm(query + ref.mha(
            query + query_pos, memory + key_pos, memory, p + "attentions.1.attn", nh),
            p + "norms.1")
        query = ref.layer_norm(ref.ffn(query, p + "ffns.0"), p + "norms.2")
        inter = ref.layer_norm(query, pre + "transformer.decoder.post_norm")

        c = f"{pre}cls_branches.{lid}."
        y = inter
        for i in (0, 3):
            y = torch.relu(ref.layer_norm(ref.linear(y, c + str(i)), c + str(i + 1)))
        cls_all.append(ref.linear(y, c + "6"))
        r = f"{pre}reg_branches.{lid}."
        t = torch.relu(ref.linear(torch.relu(ref.linear(inter, r + "reg_branch.0")),
                                  r + "reg_branch.3"))
        t = torch.cat([ref.linear(torch.relu(ref.linear(t, f"{r}task_heads.{g}.0")),
                                  f"{r}task_heads.{g}.2")
                       for g in range(len(REG_GROUPS))], dim=-1)
        xy = torch.sigmoid(t[..., 0:2] + ris[..., 0:2])
        z = torch.sigmoid(t[..., 4:5] + ris[..., 2:3])
        vel = t[..., 8:10]
        if mean_time_stamp is not None:
            vel = vel / mean_time_stamp.float()[:, None, None]
        box_all.append(torch.cat([
            xy[..., 0:1] * (pc[3] - pc[0]) + pc[0],
            xy[..., 1:2] * (pc[4] - pc[1]) + pc[1], t[..., 2:4],
            z * (pc[5] - pc[2]) + pc[2], t[..., 5:8], vel], dim=-1))
    return torch.stack(cls_all), torch.stack(box_all)


def forward_feats(ref, model, feats, lidar2img, extras):
    return head(ref, model, feats, lidar2img, extras.get("mean_time_stamp"))
