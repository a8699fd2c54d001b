"""Weights: the bridge from the JAX package's variables, and the port's
own seeded initialisation.

`state_dict_from_jax(variables)` takes flax variables as nested dicts of
arrays ({'params': ..., 'batch_stats': ...}) and returns a state_dict under
the reference's names (`img_backbone.*`, `img_neck.*`, `pts_bbox_head.*`),
key for key and value for value what
tools/convert_checkpoint.py::export_state_dict writes (for the VoVNet and
MobileNetV2 backbones, which export_state_dict does not map, the names
convert_state_dict reads back). The port's modules load it with
`strict=True`, as they load a published mmdet3d checkpoint.
The part mappers (`backbone_state_dict`, `cross_attn_state_dict`, ...)
map one flax subtree to names relative to the matching port module.

`distiller_state_dict_from_jax(variables)` does the same for a
`distill/distiller.py::Distiller` (the student under `student.`, the
lateral convs under the port module's names).

`obj_dgcnn_state_dict_from_jax(variables)` does the same for the LiDAR
detector `models/dgcnn.py::ObjDGCNN`, under names that mirror the JAX tree
(`pts_bbox_head.layer0_self_attn.conv1.weight`, ...). No upstream
checkpoint loads into it, nor into the JAX ObjDGCNN: their LayerNorms in
place of BatchNorm (pillar and SECOND layers) change the parameters.

`load_reference_checkpoint(path)` reads a `.pth` in that layout (an
upstream checkpoint, or one the port saved) for `load_state_dict`.

`init_weights(model, seed)` draws the port's random weights from a
seeded `torch.Generator`: the JAX package's initialisers, with the
zero-initialised projections perturbed so a random model exercises the
kernels.
"""

import math
from collections import OrderedDict

import numpy as np
import torch
import torch.nn as nn

from .models.attention import Deform3DCrossAttn, offset_bias_init
from .models.attention_variants import (Deform3DCrossAttnMP, Detr3DCrossAtten,
                                        Detr3DCrossAttenV2, v2_offset_bias)
from .models.dgcnn import BEVDeformableCrossAttn, DGCNN3DHead, grid_offset_bias
from .models.head import Detr3DHeadPE
from .models.layers import FrozenBatchNorm, LayerNorm
from .models.resnet import DeformConv
from .models.transformer import MultiheadAttention


def _arr(tree, path):
    node = tree
    for k in path:
        node = node[k]
    return np.asarray(node, dtype=np.float32)


class _Writer:
    """Collects reference-named arrays from one flax params / stats tree."""

    def __init__(self, params, stats=None):
        self.params, self.stats, self.sd = params, stats, OrderedDict()

    def conv(self, src, dst, bias=False):
        # flax (kh, kw, I, O) -> torch (O, I, kh, kw)
        self.sd[dst + ".weight"] = np.transpose(
            _arr(self.params, src + ["kernel"]), (3, 2, 0, 1))
        if bias:
            self.sd[dst + ".bias"] = _arr(self.params, src + ["bias"])

    def lin(self, src, dst):
        self.sd[dst + ".weight"] = _arr(self.params, src + ["kernel"]).T
        node = self.params
        for k in src:
            node = node[k]
        if "bias" in node:
            self.sd[dst + ".bias"] = np.asarray(node["bias"], np.float32)

    def bn(self, src, dst):
        for jax_name, ref_name in (("gamma", "weight"), ("beta", "bias"),
                                   ("mean", "running_mean"),
                                   ("var", "running_var")):
            self.sd[f"{dst}.{ref_name}"] = _arr(self.stats, src + [jax_name])

    def ln(self, src, dst):
        self.sd[dst + ".weight"] = _arr(self.params, src + ["scale"])
        self.sd[dst + ".bias"] = _arr(self.params, src + ["bias"])


def _prefixed(prefix, sd):
    return OrderedDict((prefix + k, v) for k, v in sd.items())


def backbone_state_dict(params, stats):
    """flax ResNet subtree -> port ResNet names (`conv1.weight`, ...)."""
    w = _Writer(params, stats)
    w.conv(["stem_conv"], "conv1")
    w.bn(["stem_bn"], "bn1")
    for name in sorted(params):
        if not name.startswith("layer"):
            continue
        stage, blk = int(name[5]), int(name.split("block")[1])
        src, dst = [name], f"layer{stage}.{blk}"
        for ci in (1, 2, 3):
            key = f"conv{ci}"
            if key not in params[name]:
                continue
            if "weight" in params[name][key]:  # DeformConv
                k = _arr(params, src + [key, "weight"])  # (9, I, O)
                _, I, O = k.shape
                w.sd[f"{dst}.{key}.weight"] = np.transpose(
                    k.reshape(3, 3, I, O), (3, 2, 0, 1))
                w.conv(src + [key, "conv_offset"], f"{dst}.{key}.conv_offset",
                       bias=True)
            else:
                w.conv(src + [key], f"{dst}.{key}")
            w.bn(src + [f"bn{ci}"], f"{dst}.bn{ci}")
        if "downsample_conv" in params[name]:
            w.conv(src + ["downsample_conv"], f"{dst}.downsample.0")
            w.bn(src + ["downsample_bn"], f"{dst}.downsample.1")
    return w.sd


def vovnet_state_dict(params, stats):
    """flax VoVNet subtree -> the reference's names
    (`stem.stem_1/conv.weight`, `stage3.OSA3_1.layers.0.OSA3_1_0/conv.weight`,
    `...concat.OSA3_1_concat/norm.*`, `...ese.fc.*`; blocks 1-based), as
    tools/convert_checkpoint.py::convert_state_dict reads them."""
    w = _Writer(params, stats)
    for k in (1, 2, 3):
        w.conv([f"stem{k}_conv"], f"stem.stem_{k}/conv")
        w.bn([f"stem{k}_bn"], f"stem.stem_{k}/norm")
    for s in range(2, 6):
        b = 0
        while f"stage{s}_osa{b}" in params:
            src, mod = [f"stage{s}_osa{b}"], f"OSA{s}_{b + 1}"
            dst = f"stage{s}.{mod}"
            i = 0
            while f"layer{i}_conv" in params[src[0]]:
                w.conv(src + [f"layer{i}_conv"],
                       f"{dst}.layers.{i}.{mod}_{i}/conv")
                w.bn(src + [f"layer{i}_bn"], f"{dst}.layers.{i}.{mod}_{i}/norm")
                i += 1
            w.conv(src + ["concat_conv"], f"{dst}.concat.{mod}_concat/conv")
            w.bn(src + ["concat_bn"], f"{dst}.concat.{mod}_concat/norm")
            w.conv(src + ["ese", "fc"], f"{dst}.ese.fc", bias=True)
            b += 1
    return w.sd


def mobilenet_state_dict(params, stats):
    """flax MobileNetV2 subtree -> mmdet's names (`conv1.conv`,
    `layer{s+1}.{b}.conv.{i}.conv|bn` for flax `stage{s}_block{b}`,
    `conv2.conv|bn`), as convert_state_dict reads them."""
    w = _Writer(params, stats)
    w.conv(["stem"], "conv1.conv")
    w.bn(["stem_bn"], "conv1.bn")
    for name in params:
        if not name.startswith("stage"):
            continue
        s, b = (int(x) for x in name[len("stage"):].split("_block"))
        parts = [p for p in ("expand", "dw", "project") if p in params[name]]
        for i, part in enumerate(parts):
            dst = f"layer{s + 1}.{b}.conv.{i}"
            w.conv([name, part], dst + ".conv")
            w.bn([name, part + "_bn"], dst + ".bn")
    if "conv2" in params:
        w.conv(["conv2"], "conv2.conv")
        w.bn(["conv2_bn"], "conv2.bn")
    return w.sd


def any_backbone_state_dict(params, stats):
    """A flax backbone subtree of any type (told by its keys) -> the
    reference's names."""
    if "stem1_conv" in params:
        return vovnet_state_dict(params, stats)
    if "stem" in params:
        return mobilenet_state_dict(params, stats)
    return backbone_state_dict(params, stats)


def neck_state_dict(params):
    w = _Writer(params)
    i = 0
    while f"lateral{i}" in params:
        w.conv([f"lateral{i}"], f"lateral_convs.{i}.conv", bias=True)
        i += 1
    i = 0
    while f"fpn_conv{i}" in params:
        w.conv([f"fpn_conv{i}"], f"fpn_convs.{i}.conv", bias=True)
        i += 1
    return w.sd


def cross_attn_state_dict(params):
    """flax cross-attention subtree -> port names, the variant told by its
    keys as export_state_dict tells it (tools/convert_checkpoint.py:
    690-714): Deform3DCrossAttn (camera gate, PE layers_i), its MP variant
    (camera gate plus a neighbour branch; export_state_dict does not map
    it: the neighbour weights, the fusion and the PE take the port
    module's names), Detr3DCrossAttenV2 (2D offsets) or Detr3DCrossAtten."""
    w = _Writer(params)
    if "cam_attention_weights" in params:
        w.lin(["cam_attention_weights"], "cam_attention_weights")
        w.lin(["sampling_offsets"], "deform_sampling_offsets")
        w.lin(["value_proj"], "value_proj")
    elif "sampling_offsets" in params:
        w.lin(["sampling_offsets"], "sampling_offsets")
    w.lin(["attention_weights"], "attention_weights")
    if "attention_weights_neighbor" in params:
        w.lin(["attention_weights_neighbor"], "attention_weights_neighbor")
        w.lin(["output_weight"], "output_weight")
    w.lin(["output_proj"], "output_proj")
    # Deform3DCrossAttn names its PE sub-layers layers_{0,1,3,4}; the
    # variants' PositionEncoderMLP is flax's Dense_i / LayerNorm_i
    pe = params["position_encoder"]
    names = (("layers_0", "layers_1", "layers_3", "layers_4")
             if "layers_0" in pe else
             ("Dense_0", "LayerNorm_0", "Dense_1", "LayerNorm_1"))
    for (src, idx), kind in zip(zip(names, (0, 1, 3, 4)),
                                (w.lin, w.ln, w.lin, w.ln)):
        kind(["position_encoder", src], f"position_encoder.{idx}")
    return w.sd


def mha_state_dict(params):
    """flax MultiHeadDotProductAttention subtree -> port MultiheadAttention
    names (the packed in_proj and out_proj)."""
    qkv, qkvb = [], []
    for name in ("query", "key", "value"):
        k = _arr(params, [name, "kernel"])  # (C, heads, hd)
        qkv.append(k.reshape(k.shape[0], -1).T)
        qkvb.append(_arr(params, [name, "bias"]).reshape(-1))
    ko = _arr(params, ["out", "kernel"])  # (heads, hd, C)
    return OrderedDict([
        ("in_proj_weight", np.concatenate(qkv, 0)),
        ("in_proj_bias", np.concatenate(qkvb, 0)),
        ("out_proj.weight", ko.reshape(-1, ko.shape[-1]).T),
        ("out_proj.bias", _arr(params, ["out", "bias"])),
    ])


def decoder_layer_state_dict(params):
    """flax DecoderLayer subtree -> port DecoderLayer names."""
    w = _Writer(params)
    w.sd.update(_prefixed("attentions.0.attn.",
                          mha_state_dict(params["self_attn"])))
    w.sd.update(_prefixed("attentions.1.",
                          cross_attn_state_dict(params["cross_attn"])))
    w.lin(["ffn", "Dense_0"], "ffns.0.layers.0.0")
    w.lin(["ffn", "Dense_1"], "ffns.0.layers.1")
    for ni in range(3):
        w.ln([f"norm{ni + 1}"], f"norms.{ni}")
    return w.sd


def depth_net_state_dict(params, stats):
    """flax DepthNet subtree -> the reference's names
    (detr3d_head_pe_camaware.py:59-105), as convert_state_dict reads them."""
    w = _Writer(params, stats)
    w.conv(["reduce_conv"], "reduce_conv.0", bias=True)
    w.bn(["reduce_bn"], "reduce_conv.1")
    w.lin(["mlp", "Dense_0"], "mlp.fc1")
    w.lin(["mlp", "Dense_1"], "mlp.fc2")
    w.conv(["se", "reduce"], "se.conv_reduce", bias=True)
    w.conv(["se", "expand"], "se.conv_expand", bias=True)
    return w.sd


def se_camconv_state_dict(params):
    """flax SELayerCAMConv subtree -> port names (the JAX tools map none)."""
    w = _Writer(params)
    w.conv(["conv_reduce", "conv"], "conv_reduce.conv", bias=True)
    w.conv(["conv_expand"], "conv_expand", bias=True)
    return w.sd


def head_state_dict(params, stats=None):
    """flax Detr3DHeadPE subtree (and its batch_stats, which hold the
    camera-aware DepthNet's BN) -> port Detr3DHeadPE names.

    The query embedding keeps every row (H-DETR's one2one then one2many
    groups). DepthNet takes the reference's names, as
    tools/convert_checkpoint.py::convert_state_dict reads them
    (`depth_net.reduce_conv.0` / `.1`, `mlp.fc1` / `fc2`, `se.conv_*`); the
    camconv gate, which the JAX tools do not map, takes the port module's
    (`fpe.conv_reduce.conv`, `fpe.conv_expand`)."""
    w = _Writer(params, stats)
    w.sd["query_embedding.weight"] = _arr(params, ["query_embedding"])
    w.lin(["reference_points"], "transformer.reference_points")
    if "depth_net" in params:
        w.sd.update(_prefixed("depth_net.", depth_net_state_dict(
            params["depth_net"], stats["depth_net"])))
    if "position_encoder" in params:  # the plain head (with_pe False) has none
        for src in ("position_encoder", "adapt_pos3d"):
            for j, tidx in enumerate((0, 2)):
                w.sd[f"{src}.{tidx}.weight"] = _arr(
                    params, [src, f"Dense_{j}", "kernel"]).T[:, :, None, None]
                w.sd[f"{src}.{tidx}.bias"] = _arr(
                    params, [src, f"Dense_{j}", "bias"])
    if "conv_reduce" in params.get("fpe", {}):  # fpe_type 'camconv'
        w.sd.update(_prefixed("fpe.", se_camconv_state_dict(params["fpe"])))
    elif "fpe" in params:  # with_fpe False calls no gate: flax made none
        w.conv(["fpe", "reduce"], "fpe.conv_reduce", bias=True)
        w.conv(["fpe", "expand"], "fpe.conv_expand", bias=True)
    lid = 0
    while f"decoder_layer{lid}" in params:
        c, r = ["cls_branch" + str(lid)], ["reg_branch" + str(lid)]
        w.lin(c + ["fc0"], f"cls_branches.{lid}.0")
        w.ln(c + ["ln0"], f"cls_branches.{lid}.1")
        w.lin(c + ["fc1"], f"cls_branches.{lid}.3")
        w.ln(c + ["ln1"], f"cls_branches.{lid}.4")
        w.lin(c + ["out"], f"cls_branches.{lid}.6")
        w.lin(r + ["fc0"], f"reg_branches.{lid}.0")
        w.lin(r + ["fc1"], f"reg_branches.{lid}.2")
        w.lin(r + ["out"], f"reg_branches.{lid}.4")
        w.sd.update(_prefixed(
            f"transformer.decoder.layers.{lid}.",
            decoder_layer_state_dict(params[f"decoder_layer{lid}"])))
        lid += 1
    return w.sd


def state_dict_from_jax(variables) -> "OrderedDict[str, torch.Tensor]":
    """Full GraphDETR4D flax variables -> reference-named state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = OrderedDict()
    sd.update(_prefixed("img_backbone.", any_backbone_state_dict(
        params["backbone"], stats["backbone"])))
    sd.update(_prefixed("img_neck.", neck_state_dict(params["neck"])))
    sd.update(_prefixed("pts_bbox_head.", head_state_dict(
        params["head"], stats.get("head"))))
    return to_torch(sd)


def distiller_state_dict_from_jax(variables) -> "OrderedDict[str, torch.Tensor]":
    """flax Distiller variables (distill/distiller.py of the JAX package:
    `student`, `lateral{i}`) -> the port's Distiller state_dict: the
    student's reference-layout dict under `student.`, then
    `lateral_convs.{i}.weight` / `.bias`. The JAX tools map no distiller
    names; the laterals take the port module's."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = _prefixed("student.", state_dict_from_jax(
        {"params": params["student"], "batch_stats": stats["student"]}))
    w = _Writer(params)
    i = 0
    while f"lateral{i}" in params:
        w.conv([f"lateral{i}"], f"lateral_convs.{i}", bias=True)
        i += 1
    sd.update(to_torch(w.sd))
    return sd


def dgcnn_attn_state_dict(params, stats):
    """flax DGCNNAttn subtree (params and batch_stats) -> port names."""
    w = _Writer(params, stats)
    for conv in ("conv1", "conv2"):
        w.lin([conv], conv)
        w.bn([conv + "_bn"], conv + "_bn")
    return w.sd


def bev_cross_attn_state_dict(params):
    """flax BEVDeformableCrossAttn subtree -> port names."""
    w = _Writer(params)
    for name in ("sampling_offsets", "attention_weights", "value_proj",
                 "output_proj"):
        w.lin([name], name)
    return w.sd


def dgcnn_head_state_dict(params, stats):
    """flax DGCNN3DHead subtree -> port DGCNN3DHead names. The FFN Dense
    layers are flax's Dense_{2l} and Dense_{2l+1} (creation order)."""
    w = _Writer(params, stats)
    w.sd["query_embedding.weight"] = _arr(params, ["query_embedding"])
    w.lin(["reference_points"], "reference_points")
    lid = 0
    while f"layer{lid}_self_attn" in params:
        pre = f"layer{lid}_"
        w.sd.update(_prefixed(pre + "self_attn.", dgcnn_attn_state_dict(
            params[pre + "self_attn"], stats[pre + "self_attn"])))
        w.sd.update(_prefixed(pre + "cross_attn.", bev_cross_attn_state_dict(
            params[pre + "cross_attn"])))
        for ni in (1, 2, 3):
            w.ln([f"{pre}norm{ni}"], f"{pre}norm{ni}")
        w.lin([f"Dense_{2 * lid}"], f"{pre}ffn.0")
        w.lin([f"Dense_{2 * lid + 1}"], f"{pre}ffn.2")
        c, r = [f"cls_branch{lid}"], [f"reg_branch{lid}"]
        for src, idx in (("fc0", 0), ("ln0", 1), ("fc1", 3), ("ln1", 4),
                         ("out", 6)):
            (w.ln if src.startswith("ln") else w.lin)(
                c + [src], f"cls_branch{lid}.{idx}")
        for src, idx in (("fc0", 0), ("fc1", 2), ("out", 4)):
            w.lin(r + [src], f"reg_branch{lid}.{idx}")
        lid += 1
    return w.sd


def pillar_encoder_state_dict(params):
    """flax PillarEncoder subtree -> port names."""
    w = _Writer(params)
    w.lin(["pfn"], "pfn")
    w.ln(["pfn_norm"], "pfn_norm")
    return w.sd


def second_backbone_state_dict(params):
    """flax SECONDBackbone subtree -> port names. flax names its LayerNorms
    LayerNorm_i in creation order: per stage the down conv's, then one
    per block."""
    w = _Writer(params)
    i, s = 0, 0
    while f"stage{s}_down" in params:
        w.conv([f"stage{s}_down"], f"stage{s}_down", bias=True)
        w.ln([f"LayerNorm_{i}"], f"stage{s}_down_norm")
        i += 1
        b = 0
        while f"stage{s}_conv{b}" in params:
            w.conv([f"stage{s}_conv{b}"], f"stage{s}_conv{b}", bias=True)
            w.ln([f"LayerNorm_{i}"], f"stage{s}_norm{b}")
            i, b = i + 1, b + 1
        s += 1
    return w.sd


def second_fpn_state_dict(params, num_inputs: int):
    """flax SECONDFPN subtree -> port names. flax names its convs Conv_i in
    creation order: the `num_inputs` laterals, their output convs, then
    the extra stride-2 convs."""
    w = _Writer(params)
    n = num_inputs
    j = 0
    while f"Conv_{j}" in params:
        kind, idx = (("lateral_convs", j) if j < n else
                     ("fpn_convs", j - n) if j < 2 * n else
                     ("extra_convs", j - 2 * n))
        w.conv([f"Conv_{j}"], f"{kind}.{idx}", bias=True)
        j += 1
    return w.sd


def obj_dgcnn_state_dict_from_jax(variables) -> "OrderedDict[str, torch.Tensor]":
    """flax ObjDGCNN variables -> the port's ObjDGCNN state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    backbone = params["pts_backbone"]
    stages = sum(1 for k in backbone if k.endswith("_down"))
    sd = _prefixed("pillar_encoder.",
                   pillar_encoder_state_dict(params["pillar_encoder"]))
    sd.update(_prefixed("pts_backbone.", second_backbone_state_dict(backbone)))
    sd.update(_prefixed("pts_neck.", second_fpn_state_dict(
        params["pts_neck"], stages)))
    sd.update(_prefixed("pts_bbox_head.", dgcnn_head_state_dict(
        params["pts_bbox_head"], stats["pts_bbox_head"])))
    return to_torch(sd)


def to_torch(sd) -> "OrderedDict[str, torch.Tensor]":
    return OrderedDict(
        (k, torch.from_numpy(np.array(v, dtype=np.float32)))
        for k, v in sd.items()
    )


def load_reference_checkpoint(path: str, model: nn.Module = None):
    """The state_dict of a `.pth` in the reference layout: an mmdet3d
    checkpoint ({'meta', 'state_dict', 'optimizer'}), a bare state_dict,
    or one of the port's own checkpoints (train/checkpoint.py). As
    tools/convert_checkpoint.py:743 reads it (`ckpt.get("state_dict",
    ckpt)`), through torch.load(weights_only=True); BatchNorm's
    `num_batches_tracked` counters, a `meta` entry and the camera-aware
    DepthNet's `context_conv` (computed and never used by the reference's
    forward, detr3d_head_pe_camaware.py:84-85; convert_state_dict skips it
    too) are dropped. With `model`, the weights are loaded into it with
    strict=True."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    sd = OrderedDict((k, v) for k, v in sd.items()
                     if k != "meta" and not k.endswith("num_batches_tracked")
                     and ".depth_net.context_conv." not in k)
    if model is not None:
        model.load_state_dict(sd, strict=True)
    return sd


# ------------------------------------------------------------ random init
# focal-loss prior -log((1 - p) / p), p = 0.01, on the last cls layer's
# bias (detr3d_head_pe.py:419-425)
CLS_PRIOR_BIAS = -math.log((1.0 - 0.01) / 0.01)

def _fan_in(p: torch.Tensor) -> int:
    return p[0].numel() if p.dim() > 1 else p.numel()


def _normal(p, std, g):
    with torch.no_grad():
        p.copy_(torch.randn(p.shape, generator=g) * std)


def _xavier_uniform(p, g):
    a = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
    with torch.no_grad():
        p.copy_((torch.rand(p.shape, generator=g) * 2.0 - 1.0) * a)


# the reg branches' output layers are drawn at this fraction of lecun scale
REG_OUT_SCALE = 0.1


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0):
    """Seeded random weights that drive every path with non-trivial values.

    The JAX package's initialisers: lecun-normal kernels and zero biases
    by default, he-normal DCN weights, xavier-uniform value/output/
    reference projections, the circular-cone offset bias, the focal prior
    on the class bias and N(0, 1) query embeddings. Two departures, so
    that random weights exercise the path as trained weights would:

    - the projections the JAX package zero-initialises (DCN
      `conv_offset`, the sampling-offset kernels, `attention_weights`,
      `cam_attention_weights`) and the identity FrozenBN statistics get
      seeded noise, so offsets, masks, attention and gates vary;
    - the reg branches' output layers are scaled by REG_OUT_SCALE, so box
      refinement moves reference points by the small steps a trained head
      takes. At full lecun scale the deltas saturate the reference
      points' sigmoid and inverse_sigmoid amplifies fp32 rounding about
      tenfold per decoder layer, so no two fp32 implementations agree
      after 6 layers.
    """
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            _normal(m.weight, 1.0 / math.sqrt(_fan_in(m.weight)), g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, MultiheadAttention):
            C = m.in_proj_weight.shape[1]
            _normal(m.in_proj_weight, 1.0 / math.sqrt(C), g)
            m.in_proj_bias.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for m in model.modules():
        if isinstance(m, DeformConv):
            _normal(m.weight, math.sqrt(2.0 / _fan_in(m.weight)), g)
            _normal(m.conv_offset.weight,
                    1.0 / math.sqrt(_fan_in(m.conv_offset.weight)), g)
            _normal(m.conv_offset.bias, 0.5, g)
        elif isinstance(m, Deform3DCrossAttn):
            for lin in (m.value_proj, m.output_proj):
                _xavier_uniform(lin.weight, g)
            for lin in (m.cam_attention_weights, m.deform_sampling_offsets,
                        m.attention_weights):
                _normal(lin.weight, 1.0 / math.sqrt(lin.in_features), g)
                lin.bias.zero_()
            m.deform_sampling_offsets.bias.copy_(torch.from_numpy(
                offset_bias_init(m.num_heads, m.num_points)))
        elif isinstance(m, Deform3DCrossAttnMP):
            for lin in (m.value_proj, m.output_proj):
                _xavier_uniform(lin.weight, g)
            for lin in (m.cam_attention_weights, m.deform_sampling_offsets,
                        m.attention_weights, m.attention_weights_neighbor):
                _normal(lin.weight, 1.0 / math.sqrt(lin.in_features), g)
                lin.bias.zero_()
            m.deform_sampling_offsets.bias.copy_(torch.from_numpy(
                offset_bias_init(m.num_heads, m.num_points)))
        elif isinstance(m, (Detr3DCrossAtten, Detr3DCrossAttenV2)):
            _xavier_uniform(m.output_proj.weight, g)
            lins = [m.attention_weights]
            if isinstance(m, Detr3DCrossAttenV2):
                lins.append(m.sampling_offsets)
            for lin in lins:
                _normal(lin.weight, 1.0 / math.sqrt(lin.in_features), g)
                lin.bias.zero_()
            if isinstance(m, Detr3DCrossAttenV2):
                m.sampling_offsets.bias.copy_(torch.from_numpy(v2_offset_bias(
                    m.num_cams, m.num_heads, m.num_levels, m.num_points)))
        elif isinstance(m, Detr3DHeadPE):
            _normal(m.query_embedding.weight, 1.0, g)
            _xavier_uniform(m.transformer.reference_points.weight, g)
            for branch in m.cls_branches:
                branch[-1].bias.fill_(CLS_PRIOR_BIAS)
            for branch in m.reg_branches:
                branch[-1].weight.mul_(REG_OUT_SCALE)
        elif isinstance(m, BEVDeformableCrossAttn):
            for lin in (m.value_proj, m.output_proj):
                _xavier_uniform(lin.weight, g)
            for lin in (m.sampling_offsets, m.attention_weights):
                _normal(lin.weight, 1.0 / math.sqrt(lin.in_features), g)
                lin.bias.zero_()
            m.sampling_offsets.bias.copy_(grid_offset_bias(
                m.num_heads, m.num_levels, m.num_points))
        elif isinstance(m, DGCNN3DHead):
            _normal(m.query_embedding.weight, 1.0, g)
            for lid in range(m.cfg.num_decoder_layers):
                getattr(m, f"cls_branch{lid}")[-1].bias.fill_(CLS_PRIOR_BIAS)
                getattr(m, f"reg_branch{lid}")[-1].weight.mul_(REG_OUT_SCALE)
        elif isinstance(m, FrozenBatchNorm):
            n = m.weight.numel()
            m.weight.copy_(torch.rand(n, generator=g) + 0.5)
            m.bias.copy_((torch.rand(n, generator=g) - 0.5) * 0.4)
            m.running_mean.copy_((torch.rand(n, generator=g) - 0.5) * 0.4)
            m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
