"""MobileNetV2 backbone, the distillation student's 'm2' (counterpart of
graph_detr4d_tpu/models/mobilenet.py; the class is mmdet's MobileNetV2,
configs/detr4d/detr4d_m2_deform_pe_testaug_320_fullset.py:51-52).

Inverted residuals (1x1 expand, depthwise 3x3 with symmetric padding 1,
1x1 linear project; relu6; a residual where the stride is 1 and the
channels match), frozen BN. Module names are mmdet's (`conv1.conv`,
`conv1.bn`, `layer{1..7}.{b}.conv.{i}.conv|bn`, `conv2.conv|bn`; `i`
counts expand, dw, project, or dw, project where the expansion is 1), so
an upstream checkpoint loads with strict=True. `out_indices` index the 7
stages (0-6) and the final 1x1 conv (7).

Runs NCHW tensors whose memory may be channels-last, like models/resnet.py.
"""

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, FrozenBatchNorm

# (expand_ratio, out_channels, num_blocks, stride): mmdet's arch settings
ARCH = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class ConvModule(nn.Module):
    """mmcv ConvModule: conv (no bias), frozen BN, relu6 where `act`."""

    def __init__(self, cin, cout, kernel, stride=1, groups=1, act=True):
        super().__init__()
        self.act = act
        self.conv = Conv2d(cin, cout, kernel, stride=stride,
                           padding=kernel // 2, groups=groups, bias=False)
        self.bn = FrozenBatchNorm(cout)

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu6(x) if self.act else x


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = cin * expand_ratio
        layers = []
        if expand_ratio != 1:
            layers.append(ConvModule(cin, hidden, 1))
        layers += [ConvModule(hidden, hidden, 3, stride, groups=hidden),
                   ConvModule(hidden, cout, 1, act=False)]
        self.conv = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        y = self.conv(x)
        return x + y if self.residual else y


class MobileNetV2(nn.Module):
    def __init__(self, out_indices: Sequence[int] = (2, 4, 7),
                 widen_factor: float = 1.0):
        super().__init__()
        self.out_indices = tuple(out_indices)

        def c(ch):
            return max(int(ch * widen_factor), 8)

        self.conv1 = ConvModule(3, c(32), 3, stride=2)
        cin = c(32)
        for s, (t, ch, n, stride) in enumerate(ARCH):
            blocks = []
            for b in range(n):
                blocks.append(InvertedResidual(cin, c(ch),
                                               stride if b == 0 else 1, t))
                cin = c(ch)
            self.add_module(f"layer{s + 1}", nn.Sequential(*blocks))
        if 7 in self.out_indices:  # the JAX module makes conv2 only then
            self.conv2 = ConvModule(
                cin, c(1280) if widen_factor > 1.0 else 1280, 1)

    @staticmethod
    def is_frozen(name: str) -> bool:
        """The JAX optimizer's frozen rule (train/optim.py:35-45: a path
        naming `stem` or `layer1`) on a parameter name relative to the
        backbone: only the stem conv (flax `stem`, mmdet `conv1`) names
        either; mmdet's `layer1` is flax's `stage0`."""
        return name.split(".")[0] == "conv1"

    @staticmethod
    def bn_folded(conv_name: str) -> bool:
        """Whether tools/fuse_conv_bn.py folds the BN after this conv, as
        the JAX tool does: the inverted residuals' (flax `expand`, `dw`,
        `project` and `*_bn`), not the stem (`stem`, `stem_bn`) or the
        final conv (`conv2`, `conv2_bn`), whose names match none of its
        FUSE_PAIRS (ROADMAP Queue 3 logs the departure)."""
        return conv_name.split(".")[0] not in ("conv1", "conv2")

    def forward(self, x):
        """x: (B, 3, H, W) -> the outputs of out_indices."""
        x = self.conv1(x)
        outs = []
        for s in range(len(ARCH)):
            x = getattr(self, f"layer{s + 1}")(x)
            if s in self.out_indices:
                outs.append(x)
        if 7 in self.out_indices:
            outs.append(self.conv2(x))
        return outs
