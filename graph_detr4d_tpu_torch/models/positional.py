"""Positional encodings (counterpart of graph_detr4d_tpu/models/positional.py).

`sine_positional_encoding_3d` reproduces SinePositionalEncoding3D
(projects/mmdet3d_plugin/models/utils/positional_encoding.py:15-100):
cumulative-sum embeddings over (camera, y, x) with normalize=True,
offset=-0.5, temperature 10000; output (B, N, H, W, 3*num_feats).
`sine_positional_encoding_2d` is mmdet's 2-axis SinePositionalEncoding of
the LiDAR head (dgcnn3d_head.py:140-141), interleaved sin / cos.
`coords_position_3d` is the PETR-style per-pixel 3D coordinates that the
flagship head and the PETR heads embed.
"""

import math
from typing import Sequence, Tuple

import torch

from ..geometry.projection import inv4x4
from ..utils.math import inverse_sigmoid


def sine_positional_encoding_3d(
    mask: torch.Tensor,
    num_feats: int = 128,
    temperature: float = 10000.0,
    offset: float = -0.5,
    eps: float = 1e-6,
    scale: float = 2 * math.pi,
    cams: slice = slice(None),
) -> torch.Tensor:
    """mask: (B, N, H, W) with 1 = padding, 0 = valid. Returns float32 (B,
    N', H, W, 3 * num_feats) for the cameras `cams` selects (N' of the N;
    default all): the camera axis is one of the encoded axes, normalised
    over all N, so a camera shard passes the whole rig's mask and encodes
    its own cameras."""
    not_mask = 1.0 - mask.float()
    n_embed = not_mask.cumsum(1)
    y_embed = not_mask.cumsum(2)
    x_embed = not_mask.cumsum(3)
    n_embed = (n_embed + offset) / (n_embed[:, -1:, :, :] + eps) * scale
    y_embed = (y_embed + offset) / (y_embed[:, :, -1:, :] + eps) * scale
    x_embed = (x_embed + offset) / (x_embed[:, :, :, -1:] + eps) * scale
    n_embed, y_embed, x_embed = (e[:, cams] for e in
                                 (n_embed, y_embed, x_embed))

    dim_t = torch.arange(num_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * (dim_t // 2) / num_feats)

    def encode(e):
        p = e[..., None] / dim_t
        # REFERENCE QUIRK: BLOCK layout [sin(p0), sin(p2), ..., cos(p1),
        # cos(p3), ...] per axis (positional_encoding.py:93-101), not
        # mmdet 2D's interleave; trained weights bake this order in.
        return torch.cat([p[..., 0::2].sin(), p[..., 1::2].cos()], dim=-1)

    return torch.cat([encode(n_embed), encode(y_embed), encode(x_embed)],
                     dim=-1)


def lid_depth_bins(depth_num: int, depth_start: float, depth_max: float,
                   device=None) -> torch.Tensor:
    """Linear-increasing-discretisation depth bin centres
    (detr3d_head_pe.py:452-455): d_i = start + bin * i * (i+1),
    bin = (max - start) / (D * (D + 1))."""
    index = torch.arange(depth_num, dtype=torch.float32, device=device)
    bin_size = (depth_max - depth_start) / (depth_num * (1 + depth_num))
    return depth_start + bin_size * index * (index + 1)


def sine_positional_encoding_2d(
    h: int,
    w: int,
    num_feats: int = 128,
    temperature: float = 10000.0,
    offset: float = -0.5,
    eps: float = 1e-6,
    scale: float = 2 * math.pi,
    device=None,
) -> torch.Tensor:
    """Sine PE over an unmasked (h, w) grid with normalize=True: (h, w,
    2 * num_feats) float32 as [y-embed, x-embed], each interleaved
    [sin(p0), cos(p1), sin(p2), cos(p3), ...] (mmdet's 2D layout, unlike
    the block layout of the 3D PE above)."""
    y_embed = (torch.arange(1, h + 1, dtype=torch.float32, device=device)
               + offset) / (h + eps) * scale
    x_embed = (torch.arange(1, w + 1, dtype=torch.float32, device=device)
               + offset) / (w + eps) * scale
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * (dim_t // 2) / num_feats)

    def encode(e):
        p = e[..., None] / dim_t
        return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()],
                           dim=-1).reshape(*e.shape, num_feats)

    pos_y = encode(y_embed)[:, None, :].expand(h, w, num_feats)
    pos_x = encode(x_embed)[None, :, :].expand(h, w, num_feats)
    return torch.cat([pos_y, pos_x], dim=-1)


def coords_position_3d(lidar2img: torch.Tensor, H: int, W: int,
                       img_shape: Tuple[int, int], depth: torch.Tensor,
                       position_range: Sequence[float]) -> torch.Tensor:
    """Per-pixel 3D coordinates of a (H, W) feature grid (detr3d_head_pe.py:
    427-491, petr_head.py:282-345), fp32: pixel (x, y) sits at (x * pad_w /
    W, y * pad_h / H) of the (pad_h, pad_w) = img_shape network input, with
    no half-pixel offset; each of the D depth bins `depth` (clamped at 1e-5)
    back-projects through the inverse of lidar2img (B, N, 4, 4), and the
    points are normalised to position_range (x0, y0, z0, x1, y1, z1) and
    inverse-sigmoided. Returns (B, N, H, W, D * 3), channels (d, xyz)."""
    B, N = lidar2img.shape[:2]
    dev = lidar2img.device
    pad_h, pad_w = img_shape
    coords_h = torch.arange(H, dtype=torch.float32, device=dev) * pad_h / H
    coords_w = torch.arange(W, dtype=torch.float32, device=dev) * pad_w / W
    d = depth.clamp(min=1e-5)
    D = d.shape[0]
    shape = (H, W, D)
    coords = torch.stack([
        (coords_w[None, :, None] * d).expand(shape),
        (coords_h[:, None, None] * d).expand(shape),
        d.expand(shape),
        torch.ones(shape, device=dev),
    ], dim=-1)  # (H, W, D, 4) homogeneous (x*d, y*d, d, 1)
    img2lidar = inv4x4(lidar2img.float())
    p3d = torch.einsum("bnij,hwdj->bnhwdi", img2lidar, coords)[..., :3]
    lo = torch.tensor(position_range[:3], device=dev)
    hi = torch.tensor(position_range[3:], device=dev)
    p3d = inverse_sigmoid((p3d - lo) / (hi - lo))
    return p3d.reshape(B, N, H, W, D * 3)
