"""ResNet backbone, mmcv 'pytorch' style (stride on the 3x3), frozen BN,
DCNv2 on stages 3-4 (counterpart of graph_detr4d_tpu/models/resnet.py).

Runs NCHW tensors whose memory may be channels-last (NHWC), which is what
cuDNN's bf16 convs and the DCN kernel want. Module and parameter names are
mmdet's (`conv1`, `bn1`, `layer3.0.conv2.conv_offset`, ...), so the
reference's state_dict loads as it is.
"""

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform_conv import TAPS, deform_conv2d
from .layers import Conv2d, FrozenBatchNorm

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
}


class DeformConv(nn.Module):
    """DCNv2 3x3 conv, no bias (mmcv ModulatedDeformConv2dPack): an
    offset/mask conv, then the deformable conv of ops/deform_conv.py.

    conv_offset gives 27 channels per pixel: 9 (dy, dx) pairs, then 9 mask
    logits (resnet.py:54-55 of the JAX package). `gather` is
    BackboneConfig.dcn_gather: with 'int8' the conv samples an int8 table
    (K3) where its input grid is large enough, as the JAX op decides
    (ops/deform_conv.select_variant)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 gather: str = "shift4"):
        super().__init__()
        self.stride = stride
        self.gather = gather
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))
        self.conv_offset = Conv2d(
            in_channels, 3 * TAPS, 3, stride=stride, padding=1
        )

    def forward(self, x):
        om = self.conv_offset(x).permute(0, 2, 3, 1)  # (B, Ho, Wo, 27)
        B, Ho, Wo, _ = om.shape
        offsets = om[..., : 2 * TAPS].reshape(B, Ho, Wo, TAPS, 2).contiguous()
        mask = torch.sigmoid(om[..., 2 * TAPS:]).contiguous()
        y = deform_conv2d(
            x.permute(0, 2, 3, 1).contiguous(), offsets, mask, self.weight,
            stride=self.stride, padding=1, variant=self.gather,
        )
        return y.permute(0, 3, 1, 2)  # NCHW view of NHWC memory


def _downsample(in_ch, out_ch, stride):
    return nn.Sequential(
        Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
        FrozenBatchNorm(out_ch),
    )


class BasicBlock(nn.Module):
    """3x3 -> 3x3 with frozen BN. mmdet's BasicBlock has no DCN."""

    expansion = 1

    def __init__(self, in_ch: int, width: int, stride: int = 1,
                 use_dcn: bool = False, dcn_gather: str = "shift4"):
        super().__init__()
        self.conv1 = Conv2d(in_ch, width, 3, stride=stride, padding=1,
                            bias=False)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = Conv2d(width, width, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(width)
        self.downsample = (
            _downsample(in_ch, width, stride)
            if stride != 1 or in_ch != width else None
        )

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, maybe DCN) -> 1x1 (x4) with frozen BN."""

    expansion = 4

    def __init__(self, in_ch: int, width: int, stride: int = 1,
                 use_dcn: bool = False, dcn_gather: str = "shift4"):
        super().__init__()
        out_ch = width * 4
        self.conv1 = Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = (
            DeformConv(width, width, stride, dcn_gather)
            if use_dcn
            else Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        )
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.downsample = (
            _downsample(in_ch, out_ch, stride)
            if stride != 1 or in_ch != out_ch else None
        )

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResNet(nn.Module):
    def __init__(
        self,
        depth: int = 50,
        out_indices: Sequence[int] = (0, 1, 2, 3),
        stage_with_dcn: Sequence[bool] = (False, False, True, True),
        use_dcn: bool = True,
        dcn_gather: str = "shift4",
    ):
        super().__init__()
        block_type, stage_blocks = ARCH_SETTINGS[depth]
        block_cls = Bottleneck if block_type == "bottleneck" else BasicBlock
        self.out_indices = tuple(out_indices)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        in_ch, width = 64, 64
        self.num_stages = len(stage_blocks)
        for stage, num_blocks in enumerate(stage_blocks):
            dcn = use_dcn and stage_with_dcn[stage]
            blocks = []
            for b in range(num_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                blocks.append(block_cls(in_ch, width, stride, use_dcn=dcn,
                                        dcn_gather=dcn_gather))
                in_ch = width * block_cls.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            width *= 2

    @staticmethod
    def is_frozen(name: str) -> bool:
        """The JAX optimizer's frozen rule (train/optim.py:35-45: a path
        naming `stem` or `layer1`) on a parameter name relative to the
        backbone: the stem (`conv1`, `bn1`) and `layer1`."""
        return name.split(".")[0] in ("conv1", "bn1", "layer1")

    def forward(self, x):
        """x: (B, 3, H, W) -> list of (B, C, H/4..H/32, W/4..W/32)."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
            if stage in self.out_indices:
                outs.append(x)
        return outs
