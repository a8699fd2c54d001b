"""Camera-aware feature modulation (counterpart of
graph_detr4d_tpu/models/camera_aware.py; reference: Detr3DHeadPECAM's
DepthNet, detr3d_head_pe_camaware.py:59-105, and the CAMConv PE gate,
detr3d_head_pe.py:22-295).

  * DepthNet: a 3x3 reduce conv + BN + relu, gated by a squeeze-excite
    whose input is each camera's pixel size (the norm of the inverse
    intrinsics' focal terms) times 1000 over the image-domain augmentation
    scale, embedded by a 1 -> C -> C relu MLP. The BN is evaluated with its
    running statistics in training too (FrozenBatchNorm), as the JAX
    module does; the reference's BN2d is live in training.
  * cam_coord_channels: CoordConv channels (normalized x / y, the field of
    view angles atan((u - cx) / fx), centred coordinates / 320) on the
    image grid, resized to the feature grid by jax.image.resize's linear
    kernel, which antialiases when it shrinks (a triangle scaled by the
    shrink factor, weights renormalized at the borders). Each channel
    depends on x alone or on y alone, so it is built from one resized
    vector per axis: the full image grid never exists.
  * CAMConv / SELayerCAMConv: the `camconv` fpe gate, whose reduce conv
    also sees those channels.

Public tensors keep the JAX layouts: features (B, N, H, W, C) channels
last, intrinsics (B, N, 4, 4), ida_scale (B, N).
"""

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..geometry.projection import inv4x4
from .layers import Conv2d, FrozenBatchNorm, Linear, PointwiseConv, SELayer

# AddCAMCoords' scale of the centred coordinates (detr3d_head_pe.py)
CENTERED_COORD_SCALE = 320.0


class _MLP(nn.Module):
    """The reference's Mlp(1, mid, mid) with ReLU: fc1, relu, fc2."""

    def __init__(self, in_features: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = Linear(in_features, hidden)
        self.fc2 = Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class DepthNet(nn.Module):
    """One instance serves every FPN level (detr3d_head_pe_camaware.py:198,
    314-319). The reference's `context_conv` is computed and never used
    (:84-85), so it has no counterpart here."""

    SCALE_DEPTH_FACTOR = 1000.0

    def __init__(self, in_channels: int, mid_channels: int):
        super().__init__()
        self.reduce_conv = nn.Sequential(
            Conv2d(in_channels, mid_channels, 3, padding=1),
            FrozenBatchNorm(mid_channels),
        )
        self.mlp = _MLP(1, mid_channels, mid_channels)
        self.se = SELayer(mid_channels)

    def forward(self, x, intrinsics, ida_scale):
        """x (B, N, H, W, C); intrinsics (B, N, 4, 4); ida_scale (B, N),
        which carries the reference's sqrt(2)|ida00| quirk (the pipeline
        computes it so). Returns (B, N, H, W, mid) in x's dtype."""
        B, N, H, W, C = x.shape
        y = self.reduce_conv(x.reshape(B * N, H, W, C).permute(0, 3, 1, 2))
        y = F.relu(y).permute(0, 2, 3, 1).reshape(B, N, H, W, -1)
        inv_k = inv4x4(intrinsics)
        pixel_size = torch.sqrt(inv_k[..., 0, 0] ** 2 + inv_k[..., 1, 1] ** 2)
        scaled = (pixel_size * self.SCALE_DEPTH_FACTOR
                  / ida_scale.float().clamp(min=1e-6))[..., None]
        se = self.mlp(scaled.to(x.dtype))[:, :, None, None, :]  # (B, N, 1, 1, mid)
        # the 1x1 gate of a broadcast input is the broadcast of the gate
        return self.se(y, se)


def resize_weights(input_size: int, output_size: int,
                   device=None) -> torch.Tensor:
    """(input_size, output_size) float32 weights of jax.image.resize's
    linear kernel with antialias (jax._src.image.scale.compute_weight_mat
    at translation 0)."""
    inv_scale = 1.0 / (output_size / input_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = ((torch.arange(output_size, dtype=torch.float32, device=device)
                 + 0.5) * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(input_size, dtype=torch.float32,
                                          device=device)[:, None]).abs()
    weights = (1.0 - x / kernel_scale).clamp(min=0.0)
    total = weights.sum(0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * 1.1920929e-07,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def cam_coord_channels(
    feat_h: int,
    feat_w: int,
    img_h: float,
    img_w: float,
    fx: torch.Tensor,
    fy: torch.Tensor,
    cx: torch.Tensor,
    cy: torch.Tensor,
) -> torch.Tensor:
    """(B, N, feat_h, feat_w, 6) float32 camera-aware coordinate channels
    (AddCAMCoords, detr3d_head_pe.py:22-163) of an img_h x img_w image
    resized to the feature grid; fx, fy, cx, cy (B, N). Channel order as
    JAX: nx, ny, atan(cent_x / fx), atan(cent_y / fy), cent_x / 320,
    cent_y / 320 (cent = pixel - principal point + 0.5). No gradient
    flows (stop_gradient in JAX)."""
    B, N = fx.shape
    w, h = int(img_w), int(img_h)
    dev = fx.device
    with torch.no_grad():
        wx = resize_weights(w, feat_w, dev)  # (w, feat_w)
        wy = resize_weights(h, feat_h, dev)  # (h, feat_h)
        # the resize of a channel constant along an axis multiplies it by
        # that axis' weight sums
        sum_x, sum_y = wx.sum(0), wy.sum(0)
        xx = torch.arange(w, dtype=torch.float32, device=dev)
        yy = torch.arange(h, dtype=torch.float32, device=dev)

        def along_x(v):  # (..., w) -> (B, N, feat_h, feat_w)
            r = (v @ wx).expand(B, N, feat_w)
            return r[:, :, None, :] * sum_y[:, None]

        def along_y(v):  # (..., h) -> (B, N, feat_h, feat_w)
            r = (v @ wy).expand(B, N, feat_h)
            return r[:, :, :, None] * sum_x

        fx, fy, cx, cy = (t.float()[..., None] for t in (fx, fy, cx, cy))
        cent_x = xx - cx + 0.5  # (B, N, w)
        cent_y = yy - cy + 0.5
        return torch.stack([
            along_x((xx / (w - 1)) * 2.0 - 1.0),
            along_y((yy / (h - 1)) * 2.0 - 1.0),
            along_x(torch.atan(cent_x / fx)),
            along_y(torch.atan(cent_y / fy)),
            along_x(cent_x / CENTERED_COORD_SCALE),
            along_y(cent_y / CENTERED_COORD_SCALE),
        ], dim=-1)


class CAMConv(nn.Module):
    """1x1 conv over the features with cam_coord_channels prepended
    (CAMConv, detr3d_head_pe.py:166-243)."""

    EXTRA_CHANNELS = 6

    def __init__(self, in_channels: int, out_channels: int,
                 img_shape: Tuple[int, int]):
        super().__init__()
        self.img_shape = tuple(img_shape)
        self.conv = PointwiseConv(in_channels + self.EXTRA_CHANNELS,
                                  out_channels)

    def forward(self, x, intrinsics):
        """x (B, N, H, W, C); intrinsics (B, N, 4, 4) padded K."""
        _, _, H, W, _ = x.shape
        k = intrinsics.float()
        extra = cam_coord_channels(
            H, W, self.img_shape[0], self.img_shape[1], k[..., 0, 0],
            k[..., 1, 1], k[..., 0, 2], k[..., 1, 2])
        return self.conv(torch.cat([extra.to(x.dtype), x], dim=-1))


class SELayerCAMConv(nn.Module):
    """SE gate whose reduce conv is camera-aware (SELayerCAMConvV1,
    detr3d_head_pe.py:277-295): pe * sigmoid(expand(relu(CAMConv(feat)))),
    the sigmoid in fp32. Without intrinsics the identity is used."""

    def __init__(self, channels: int, img_shape: Tuple[int, int]):
        super().__init__()
        self.conv_reduce = CAMConv(channels, channels, img_shape)
        self.conv_expand = PointwiseConv(channels, channels)

    def forward(self, pe, feat, intrinsics=None):
        B, N = feat.shape[:2]
        if intrinsics is None:
            intrinsics = torch.eye(4, device=feat.device).expand(B, N, 4, 4)
        y = self.conv_expand(F.relu(self.conv_reduce(feat, intrinsics)))
        return pe * torch.sigmoid(y.float()).to(pe.dtype)
