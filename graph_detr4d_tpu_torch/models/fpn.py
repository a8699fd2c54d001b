"""Feature Pyramid Network with mmdet semantics as configured at
configs/detr4d/...12e.py:42-49: start_level=1, add_extra_convs='on_output',
num_outs=4, relu_before_extra_convs=True (counterpart of
graph_detr4d_tpu/models/fpn.py).

mmdet quirk kept exactly: the FIRST extra conv sees the raw source without
relu; `relu_before_extra_convs` inserts relu from the second extra conv on.
NCHW; nearest-neighbour top-down upsampling.

`cp=True` is the reference's CPFPN (models/necks/cp_fpn.py:182-185), the
PETR family's neck: the 3x3 output conv exists and runs only on level 0,
higher levels pass their lateral through. The reference builds no
`fpn_convs.{i>0}` for those levels, so `fpn_convs` holds the level-0 conv
and then the extra levels' convs: the JAX module's `fpn_conv{i}` of an
extra level (i counts from the number of laterals) is `fpn_convs.{i -
laterals + 1}` here, as the reference appends it.
"""

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d


class ConvModule(nn.Module):
    """mmcv ConvModule without norm/act: holds `.conv`."""

    def __init__(self, cin, cout, kernel_size, stride=1, padding=0):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel_size, stride=stride,
                           padding=padding)

    def forward(self, x):
        return self.conv(x)


def _upsample_nearest(x, target_hw):
    th, tw = target_hw
    H, W = x.shape[-2:]
    ry, rx = th // H, tw // W
    x = F.interpolate(x, size=(H * ry, W * rx), mode="nearest")
    return x[..., :th, :tw]


class FPN(nn.Module):
    def __init__(
        self,
        in_channels: Sequence[int],
        out_channels: int = 256,
        start_level: int = 1,
        num_outs: int = 4,
        relu_before_extra_convs: bool = True,
        cp: bool = False,
    ):
        super().__init__()
        self.start_level = start_level
        self.num_outs = num_outs
        self.relu_before_extra_convs = relu_before_extra_convs
        used = list(in_channels[start_level:])
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1) for c in used
        )
        # the levels with a 3x3 output conv: all, or level 0 under cp
        self.conv_levels = 1 if cp else len(used)
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, padding=1)
            for _ in range(self.conv_levels)
        )
        for _ in range(len(used), num_outs):
            self.fpn_convs.append(
                ConvModule(out_channels, out_channels, 3, stride=2, padding=1)
            )

    def forward(self, inputs):
        used = list(inputs[self.start_level:])
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, used)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + _upsample_nearest(
                laterals[i], laterals[i - 1].shape[-2:]
            )
        n = self.conv_levels
        outs = [self.fpn_convs[i](x) if i < n else x
                for i, x in enumerate(laterals)]
        for i in range(len(laterals), self.num_outs):
            src = outs[-1]
            if self.relu_before_extra_convs and i > len(laterals):
                src = F.relu(src)
            outs.append(self.fpn_convs[n + i - len(laterals)](src))
        return outs
