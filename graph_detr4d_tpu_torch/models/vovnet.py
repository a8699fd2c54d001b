"""VoVNet-V2 backbone: OSA modules with eSE attention (counterpart of
graph_detr4d_tpu/models/vovnet.py; reference
models/backbones/vovnet.py:276-383 and vovnetcp.py).

Module names are the reference's, `/` included (`stem.stem_1/conv`,
`stage3.OSA3_2.layers.0.OSA3_2_0/norm`, `...concat.OSA3_2_concat/conv`,
`...ese.fc`), blocks 1-based, so an upstream checkpoint loads with
strict=True. BN is frozen, as the reference trains it (norm_eval).
`remat` recomputes each OSA block in the backward
(torch.utils.checkpoint), the JAX module's nn.remat and the reference's
VoVNetCP.

Runs NCHW tensors whose memory may be channels-last, like models/resnet.py.
"""

from collections import OrderedDict
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import Conv2d, FrozenBatchNorm

VOVNET_SPECS = {
    "V-19-slim-eSE": dict(
        stem=[64, 64, 128],
        stage_conv_ch=[64, 80, 96, 112],
        stage_out_ch=[112, 256, 384, 512],
        layer_per_block=3,
        block_per_stage=[1, 1, 1, 1],
    ),
    "V-19-eSE": dict(
        stem=[64, 64, 128],
        stage_conv_ch=[128, 160, 192, 224],
        stage_out_ch=[256, 512, 768, 1024],
        layer_per_block=3,
        block_per_stage=[1, 1, 1, 1],
    ),
    "V-39-eSE": dict(
        stem=[64, 64, 128],
        stage_conv_ch=[128, 160, 192, 224],
        stage_out_ch=[256, 512, 768, 1024],
        layer_per_block=5,
        block_per_stage=[1, 1, 2, 2],
    ),
    "V-57-eSE": dict(
        stem=[64, 64, 128],
        stage_conv_ch=[128, 160, 192, 224],
        stage_out_ch=[256, 512, 768, 1024],
        layer_per_block=5,
        block_per_stage=[1, 1, 4, 3],
    ),
    "V-99-eSE": dict(
        stem=[64, 64, 128],
        stage_conv_ch=[128, 160, 192, 224],
        stage_out_ch=[256, 512, 768, 1024],
        layer_per_block=5,
        block_per_stage=[1, 3, 9, 3],
    ),
}


def _conv_bn_relu(cin, cout, name, stride=1, kernel=3):
    """The reference's conv3x3 / conv1x1: `{name}/conv`, `{name}/norm`,
    `{name}/relu`."""
    return [
        (f"{name}/conv", Conv2d(cin, cout, kernel, stride=stride,
                                padding=kernel // 2, bias=False)),
        (f"{name}/norm", FrozenBatchNorm(cout)),
        (f"{name}/relu", nn.ReLU()),
    ]


class ESEModule(nn.Module):
    """Effective squeeze-excite: global average pool, 1x1 conv with bias,
    hard sigmoid clip(s + 3, 0, 6) / 6."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = Conv2d(channels, channels, 1)

    def forward(self, x):
        s = self.fc(x.mean(dim=(2, 3), keepdim=True))
        return x * (torch.clamp(s + 3.0, 0.0, 6.0) / 6.0)


class OSAModule(nn.Module):
    """One-shot aggregation: layer_per_block 3x3 convs, the input and
    every layer's output concatenated, a 1x1 conv, eSE, and the input
    added back for every block of a stage but its first."""

    def __init__(self, in_ch: int, stage_ch: int, concat_ch: int,
                 layer_per_block: int, name: str, identity: bool = False):
        super().__init__()
        self.identity = identity
        self.layers = nn.ModuleList()
        ch = in_ch
        for i in range(layer_per_block):
            self.layers.append(nn.Sequential(OrderedDict(
                _conv_bn_relu(ch, stage_ch, f"{name}_{i}"))))
            ch = stage_ch
        self.concat = nn.Sequential(OrderedDict(_conv_bn_relu(
            in_ch + layer_per_block * stage_ch, concat_ch, f"{name}_concat",
            kernel=1)))
        self.ese = ESEModule(concat_ch)

    def forward(self, x):
        outputs = [x]
        y = x
        for layer in self.layers:
            y = layer(y)
            outputs.append(y)
        y = self.ese(self.concat(torch.cat(outputs, dim=1)))
        return y + x if self.identity else y


class VoVNet(nn.Module):
    def __init__(self, spec_name: str = "V-99-eSE",
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 remat: bool = False):
        super().__init__()
        spec = VOVNET_SPECS[spec_name]
        self.out_indices = tuple(out_indices)
        self.remat = remat
        s1, s2, s3 = spec["stem"]
        self.stem = nn.Sequential(OrderedDict(
            _conv_bn_relu(3, s1, "stem_1", stride=2)
            + _conv_bn_relu(s1, s2, "stem_2")
            + _conv_bn_relu(s2, s3, "stem_3", stride=2)))
        in_ch = s3
        for stage in range(4):
            blocks = []
            for b in range(spec["block_per_stage"][stage]):
                name = f"OSA{stage + 2}_{b + 1}"
                blocks.append((name, OSAModule(
                    in_ch, spec["stage_conv_ch"][stage],
                    spec["stage_out_ch"][stage], spec["layer_per_block"],
                    name, identity=b > 0)))
                in_ch = spec["stage_out_ch"][stage]
            self.add_module(f"stage{stage + 2}",
                            nn.Sequential(OrderedDict(blocks)))

    @staticmethod
    def is_frozen(name: str) -> bool:
        """The JAX optimizer's frozen rule (train/optim.py:35-45: a path
        naming `stem` or `layer1`) on a parameter name relative to the
        backbone: the three stem convs and every OSA block's second 3x3
        conv (flax `layer1_conv`, reference `layers.1`)."""
        parts = name.split(".")
        return parts[0] == "stem" or parts[2:4] == ["layers", "1"]

    @staticmethod
    def bn_folded(conv_name: str) -> bool:
        """Whether tools/fuse_conv_bn.py folds the BN after this conv, as
        the JAX tool does: never, since its flax names (`{name}_conv`,
        `{name}_bn`) match none of its FUSE_PAIRS (upstream mmcv would fold
        them all; ROADMAP Queue 3 logs the departure)."""
        return False

    def forward(self, x):
        """x: (B, 3, H, W) -> the stages of out_indices, (B, C, H/4..H/32,
        W/4..W/32)."""
        x = self.stem(x)
        outs = []
        for stage in range(4):
            if stage > 0:
                # the reference's MaxPool2d(3, 2, ceil_mode=True) with no
                # padding: the JAX module pads right and bottom with -inf
                x = F.max_pool2d(x, 3, stride=2, ceil_mode=True)
            for block in getattr(self, f"stage{stage + 2}"):
                if self.remat and torch.is_grad_enabled():
                    x = checkpoint(block, x, use_reentrant=False)
                else:
                    x = block(x)
            if stage in self.out_indices:
                outs.append(x)
        return outs
