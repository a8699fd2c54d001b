"""Camera-matrix math (counterpart of graph_detr4d_tpu/geometry/projection.py).

`project_points_to_cameras` is the one camera projection of the camera
decoder's cross-attentions (models/attention.py, attention_variants.py);
`points_img2cam` is the geometry API's.
"""

import torch

from ..utils.device import device_constant


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of batched (..., 3, 3) matrices, fp32,
    with the JAX package's arithmetic (no LU)."""
    m = m.float()
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = torch.stack(
        [
            torch.stack([co_a, c * h - b * i, b * f - c * e], dim=-1),
            torch.stack([co_b, a * i - c * g, c * d - a * f], dim=-1),
            torch.stack([co_c, b * g - a * h, a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def inv4x4(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched (..., 4, 4) matrices via 2x2 minors.

    Kept instead of `torch.linalg.inv` so the port inverts lidar2img with
    the same arithmetic as the JAX package (branch-free, fp32, no LU).
    """
    m = m.float()
    a = [[m[..., i, j] for j in range(4)] for i in range(4)]
    (a00, a01, a02, a03), (a10, a11, a12, a13) = a[0], a[1]
    (a20, a21, a22, a23), (a30, a31, a32, a33) = a[2], a[3]

    # 2x2 minors of rows (0,1) and rows (2,3)
    s0 = a00 * a11 - a01 * a10
    s1 = a00 * a12 - a02 * a10
    s2 = a00 * a13 - a03 * a10
    s3 = a01 * a12 - a02 * a11
    s4 = a01 * a13 - a03 * a11
    s5 = a02 * a13 - a03 * a12
    c5 = a22 * a33 - a23 * a32
    c4 = a21 * a33 - a23 * a31
    c3 = a21 * a32 - a22 * a31
    c2 = a20 * a33 - a23 * a30
    c1 = a20 * a32 - a22 * a30
    c0 = a20 * a31 - a21 * a30

    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    inv_det = 1.0 / det

    rows = [
        [
            (a11 * c5 - a12 * c4 + a13 * c3) * inv_det,
            (-a01 * c5 + a02 * c4 - a03 * c3) * inv_det,
            (a31 * s5 - a32 * s4 + a33 * s3) * inv_det,
            (-a21 * s5 + a22 * s4 - a23 * s3) * inv_det,
        ],
        [
            (-a10 * c5 + a12 * c2 - a13 * c1) * inv_det,
            (a00 * c5 - a02 * c2 + a03 * c1) * inv_det,
            (-a30 * s5 + a32 * s2 - a33 * s1) * inv_det,
            (a20 * s5 - a22 * s2 + a23 * s1) * inv_det,
        ],
        [
            (a10 * c4 - a11 * c2 + a13 * c0) * inv_det,
            (-a00 * c4 + a01 * c2 - a03 * c0) * inv_det,
            (a30 * s4 - a31 * s2 + a33 * s0) * inv_det,
            (-a20 * s4 + a21 * s2 - a23 * s0) * inv_det,
        ],
        [
            (-a10 * c3 + a11 * c1 - a12 * c0) * inv_det,
            (a00 * c3 - a01 * c1 + a02 * c0) * inv_det,
            (-a30 * s3 + a31 * s1 - a32 * s0) * inv_det,
            (a20 * s3 - a21 * s1 + a22 * s0) * inv_det,
        ],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def denormalize_points(pts01: torch.Tensor, pc_range) -> torch.Tensor:
    """[0,1]-normalized 3D points -> metric lidar coords in pc_range."""
    lo = device_constant(pc_range[:3], pts01.dtype, pts01.device)
    hi = device_constant(pc_range[3:], pts01.dtype, pts01.device)
    return pts01 * (hi - lo) + lo


def normalize_points(pts: torch.Tensor, pc_range) -> torch.Tensor:
    """Metric lidar coords -> [0,1] normalized by pc_range."""
    lo = device_constant(pc_range[:3], pts.dtype, pts.device)
    hi = device_constant(pc_range[3:], pts.dtype, pts.device)
    return (pts - lo) / (hi - lo)


def project_points_to_cameras(points: torch.Tensor, lidar2img: torch.Tensor,
                              img_shape, eps: float = 1e-5):
    """Project metric 3D points into every camera (reference
    deform3d_cross_attn.py:232-258: homogeneous product, eps-guarded depth
    divide, in front of the camera and strictly inside the image).

    points (B, P, 3) metric lidar-frame points; lidar2img (B, N, 4, 4);
    img_shape (img_h, img_w), the network input's size. Returns loc (B, N,
    P, 2) in [0, 1] (x, y) and mask (B, N, P) in points' dtype.
    """
    img_h, img_w = img_shape
    hom = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    cam = torch.einsum("bnij,bpj->bnpi", lidar2img, hom)
    z = cam[..., 2:3]
    in_front = z > eps
    xy = cam[..., 0:2] / z.clamp(min=eps)
    loc = xy / device_constant((img_w, img_h), xy.dtype, xy.device)
    valid = (
        in_front
        & (loc[..., 0:1] > 0.0)
        & (loc[..., 0:1] < 1.0)
        & (loc[..., 1:2] > 0.0)
        & (loc[..., 1:2] < 1.0)
    )
    return loc, valid[..., 0].to(points.dtype)


def points_img2cam(points: torch.Tensor, cam2img: torch.Tensor) -> torch.Tensor:
    """2.5D image points (u, v, depth) (P, 3) -> 3D camera coordinates (P,
    3) (core/bbox/util.py points_img2cam:5-35). cam2img may be (3, 3),
    (3, 4) or (4, 4); it is padded into a 4x4 identity before inversion."""
    points = points.float()
    cam2img = cam2img.float()
    pad = torch.eye(4, dtype=torch.float32, device=cam2img.device)
    pad[: cam2img.shape[0], : cam2img.shape[1]] = cam2img
    xys = points[:, :2]
    depths = points[:, 2:3]
    unnormed = torch.cat([xys * depths, depths], dim=1)
    homo = torch.cat([unnormed, torch.ones_like(depths)], dim=1)
    return (homo @ inv4x4(pad).T)[:, :3]
