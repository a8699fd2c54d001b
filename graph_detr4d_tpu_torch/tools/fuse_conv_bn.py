"""Fold frozen-BN statistics into the convs before them, for inference
(counterpart of tools/misc/fuse_conv_bn.py; reference mmcv's
fuse_conv_bn over a torch checkpoint).

    python -m graph_detr4d_tpu_torch.tools.fuse_conv_bn \\
        --in-dir CKPT --out-dir CKPT_FUSED [--tiny | --config NAME] \\
        [--device cuda]

The backbones run BN as a frozen per-channel affine (models/layers.py
FrozenBatchNorm): y = conv(x) * scale + bias, scale = gamma / sqrt(var +
eps), bias = beta - mean * scale. The fold multiplies the conv's weight
(and its bias, where it has one) by scale along the output channel, and
leaves the BN the pure add gamma 1, beta `bias`, mean 0, var 1 - eps, so
that sqrt(var + eps) is exactly 1. The BN still runs.

The pairs come from the backbone module's tree: in every module, a conv
child registered directly before a FrozenBatchNorm child (mmcv's rule; a
DeformConv is no nn.Conv2d, and the JAX tool leaves it too, since flax's
DeformConv has no `kernel` leaf), kept where the backbone class's
`bn_folded(conv_name)` says the JAX tool's names match its FUSE_PAIRS.
So the fold takes the JAX tool's set: ResNet-18 20 pairs, ResNet-50 53,
R50-DCN 44, VoVNet-99 0, MobileNetV2 50 (ROADMAP Queue 3 logs the last
two against upstream).

The CLI restores the newest checkpoint of --in-dir
(train/checkpoint.py::CheckpointManager), loads its weights into the
model of --tiny / --config (the default ModelConfig otherwise) with
strict=True, folds them on --device and saves the checkpoint, optimizer
state included, at the same step under --out-dir.
"""

import argparse

import torch
import torch.nn as nn

from ..models.layers import FrozenBatchNorm

EPS = 1e-5


def conv_bn_pairs(backbone: nn.Module):
    """[(conv, bn)] module names, relative to the backbone, that the fold
    takes, in the module tree's order."""
    pairs = []
    for scope, module in backbone.named_modules():
        prev = None
        for name, child in module.named_children():
            full = f"{scope}.{name}" if scope else name
            if (isinstance(child, FrozenBatchNorm) and prev is not None
                    and backbone.bn_folded(prev)):
                pairs.append((prev, full))
            prev = full if isinstance(child, nn.Conv2d) else None
    return pairs


@torch.no_grad()
def fuse_state_dict(state_dict, backbone: nn.Module,
                    prefix: str = "img_backbone.") -> int:
    """Fold each of conv_bn_pairs(backbone) in `state_dict` (the reference
    layout: the backbone's tensors under `prefix`) in place, in fp32 on the
    tensors' device. Returns the number of pairs folded."""
    n = 0
    for conv, bn in conv_bn_pairs(backbone):
        c, b = prefix + conv, prefix + bn
        gamma, beta = state_dict[f"{b}.weight"], state_dict[f"{b}.bias"]
        mean, var = state_dict[f"{b}.running_mean"], state_dict[f"{b}.running_var"]
        scale = gamma / torch.sqrt(var + EPS)
        w = state_dict[f"{c}.weight"]
        state_dict[f"{c}.weight"] = (w * scale.view(-1, 1, 1, 1)).to(w.dtype)
        if f"{c}.bias" in state_dict:
            state_dict[f"{c}.bias"] = (state_dict[f"{c}.bias"] * scale).to(w.dtype)
        state_dict[f"{b}.weight"] = torch.ones_like(gamma)
        state_dict[f"{b}.bias"] = (beta - mean * scale).to(beta.dtype)
        state_dict[f"{b}.running_mean"] = torch.zeros_like(mean)
        state_dict[f"{b}.running_var"] = torch.ones_like(var) * (1.0 - EPS)
        n += 1
    return n


def build_config(args):
    """The JAX tool's configs: the tiny test config, a named config, or
    the default ModelConfig."""
    from ..config import ModelConfig, tiny_test_config
    from ..configs import get_config

    if args.tiny:
        return tiny_test_config()
    return get_config(args.config) if args.config else ModelConfig()


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="graph_detr4d_tpu_torch.tools.fuse_conv_bn")
    p.add_argument("--in-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--config", default=None)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    from ..models.detector import GraphDETR4D
    from ..train.checkpoint import CheckpointManager
    from ..utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = build_config(args)
    model = GraphDETR4D(cfg, device=device)
    ckpt = CheckpointManager(args.in_dir, cfg).restore(map_location=device)
    if ckpt is None:
        raise SystemExit(f"no checkpoint in {args.in_dir}")
    model.load_state_dict(ckpt["state_dict"], strict=True)
    n = fuse_state_dict(ckpt["state_dict"], model.img_backbone)
    state = {k: v for k, v in ckpt.items() if k not in ("step", "meta")}
    CheckpointManager(args.out_dir, cfg).save(
        ckpt["meta"]["step"], state, ckpt["meta"].get("metrics"))
    print(f"fused {n} conv+bn pairs -> {args.out_dir}")
    return n


if __name__ == "__main__":
    main()
