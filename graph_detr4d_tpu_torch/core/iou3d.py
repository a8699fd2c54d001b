"""3D / BEV IoU calculators (counterpart of graph_detr4d_tpu/core/iou3d.py;
reference: core/bbox/iou_calculators/iou3d_calculator.py:8-298).

  * `bbox_overlaps_nearest_3d`: boxes snapped to their nearest
    axis-aligned BEV rectangle, then a 2D IoU / IoF (`bbox_overlaps_2d`);
    plain PyTorch on any device.
  * `bbox_overlaps_3d`: the exact rotated BEV overlap times the z-extent
    overlap, IoU or IoF; `rotated_overlap_bev` the BEV overlap of one
    pair. K7: for CUDA tensors one launch of the kernel of
    `csrc/iou3d.cu` (tiles of 32 x 32 pairs, corners computed in the
    kernel, pairs whose bounding circles lie apart by more than
    PRETEST_MARGIN of their coordinate scale answered 0 without clipping);
    for CPU tensors `bbox_overlaps_3d_plain`, the JAX op's fixed-size
    Sutherland–Hodgman clip written out over all pairs. The kernel has no
    backward: on CUDA tensors that require grad, with grad enabled, it
    raises (the plain version differentiates; no model path needs it).

The kernel computes the rotated corners with the formula and order of
`box_corners_bev`, and then repeats the plain version's float operations
in its order, without fused multiply-adds, so both clip the same float32
polygons. Boxes are (cx, cy, cz, w, l, h, yaw) in LiDAR coordinates
(gravity-centre z).
"""

import ctypes
import functools
from typing import Optional

import torch

from ..ops import build

# kernel launches made by bbox_overlaps_3d / rotated_overlap_bev (a plain
# int; chip_smoke.py resets it before driving the entry point and reads it
# after)
launches = 0

V_MAX = 8  # a quad clipped by 4 half-planes has <= 8 vertices
# the kernel's pre-test margin, a share of a pair's coordinate scale (the
# largest centre coordinate plus both bounding-circle radii; the clip's
# rounding is ~1e-6 of it, so the clip of a pair apart by more is empty)
PRETEST_MARGIN = 1e-3
_MODES = {"iou": 0, "iof": 1, "bev": 2}


@functools.cache
def _lib():
    lib = build.load("iou3d")
    lib.box_overlaps_3d.argtypes = [ctypes.c_void_p, ctypes.c_int] * 2 + [
        ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_float] + [
        ctypes.c_void_p] * 2
    lib.box_overlaps_3d.restype = ctypes.c_int
    return lib


def _nearest_bev(boxes):
    """(..., 7) -> (..., 4) axis-aligned BEV (x1, y1, x2, y2): the box with
    yaw rounded to the nearest multiple of pi/2 (mmdet3d `nearest_bev`)."""
    cx, cy, w, l, yaw = (boxes[..., i] for i in (0, 1, 3, 4, 6))
    rot = torch.remainder(yaw, torch.pi).abs()
    swap = (rot > torch.pi / 4) & (rot < 3 * torch.pi / 4)
    ew = torch.where(swap, l, w)
    el = torch.where(swap, w, l)
    return torch.stack([cx - ew / 2, cy - el / 2, cx + ew / 2, cy + el / 2], -1)


def bbox_overlaps_2d(b1, b2, mode: str = "iou"):
    """Axis-aligned (x1, y1, x2, y2) overlaps: (M, 4) x (N, 4) -> (M, N)."""
    lt = torch.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = torch.minimum(b1[:, None, 2:], b2[None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (b1[:, 2] - b1[:, 0]) * (b1[:, 3] - b1[:, 1])
    a2 = (b2[:, 2] - b2[:, 0]) * (b2[:, 3] - b2[:, 1])
    if mode == "iou":
        union = a1[:, None] + a2[None, :] - inter
    elif mode == "iof":
        union = a1[:, None] * torch.ones_like(a2)[None, :]
    else:
        raise ValueError(mode)
    return inter / union.clamp(min=1e-8)


def bbox_overlaps_nearest_3d(bboxes1, bboxes2, mode: str = "iou"):
    """(M, 7+) x (N, 7+) -> (M, N) nearest-aligned BEV IoU / IoF
    (iou3d_calculator.py:84-124)."""
    return bbox_overlaps_2d(_nearest_bev(bboxes1), _nearest_bev(bboxes2),
                            mode=mode)


def box_corners_bev(boxes):
    """(..., 7) -> (..., 4, 2) rotated BEV corners, counter-clockwise
    (interior left of each edge, as the half-plane test requires)."""
    cx, cy, w, l, yaw = (boxes[..., i] for i in (0, 1, 3, 4, 6))
    dx = torch.stack([w, -w, -w, w], -1) / 2
    dy = torch.stack([l, l, -l, -l], -1) / 2
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    x = cx[..., None] + dx * c - dy * s
    y = cy[..., None] + dx * s + dy * c
    return torch.stack([x, y], -1)


def _clip_poly(pts, count, a, b):
    """One Sutherland–Hodgman step over K polygons at once: clip each
    padded convex polygon (pts (K, V_MAX, 2), `count` valid, the tail
    copies of vertex 0) by the half-plane left of its edge a -> b (K, 2).
    Emits per input edge the current vertex if inside (side >= 0), then
    the edge's crossing, in order, keeping the first V_MAX."""
    K, V = pts.shape[:2]
    e = b - a

    def side(p):
        return (e[:, None, 0] * (p[..., 1] - a[:, None, 1])
                - e[:, None, 1] * (p[..., 0] - a[:, None, 0]))

    idx = torch.arange(V, device=pts.device)
    cur = pts
    nxt = torch.roll(pts, -1, dims=1)
    # the edge leaving the last valid vertex closes back to vertex 0
    last = (idx[None, :] == (count - 1)[:, None])[..., None]
    nxt = torch.where(last, pts[:, :1], nxt)
    s_cur, s_nxt = side(cur), side(nxt)
    denom = s_cur - s_nxt
    t = s_cur / torch.where(denom.abs() < 1e-12,
                            torch.full_like(denom, 1e-12), denom)
    inter = cur + t[..., None] * (nxt - cur)
    valid_edge = idx[None, :] < count[:, None]
    emit_cur = (s_cur >= 0) & valid_edge
    emit_int = ((s_cur >= 0) ^ (s_nxt >= 0)) & valid_edge
    flags = torch.stack([emit_cur, emit_int], 2).reshape(K, 2 * V)
    cands = torch.stack([cur, inter], 2).reshape(K, 2 * V, 2)
    # stable compaction: the emitted points in order, the rest to a dead
    # slot past the end
    pos = flags.long().cumsum(1) - 1
    pos = torch.where(flags, pos, torch.full_like(pos, 2 * V))
    out = torch.zeros(K, 2 * V + 1, 2, dtype=pts.dtype, device=pts.device)
    out.scatter_(1, pos[..., None].expand(-1, -1, 2), cands)
    new_count = flags.sum(1).clamp(max=V)
    keep = (torch.arange(2 * V + 1, device=pts.device)[None, :]
            < new_count[:, None])[..., None]
    out = torch.where(keep, out, out[:, :1])
    return out[:, :V], new_count


def _polygon_area(pts):
    """Shoelace over a padded vertex buffer, summed in vertex order: the
    tail repeats vertex 0 and adds exact zeros."""
    x, y = pts[..., 0], pts[..., 1]
    xn, yn = torch.roll(x, -1, dims=-1), torch.roll(y, -1, dims=-1)
    terms = x * yn - xn * y
    acc = terms[..., 0]
    for j in range(1, terms.shape[-1]):
        acc = acc + terms[..., j]
    return 0.5 * acc.abs()


def rotated_overlaps_bev_plain(c1, c2):
    """Pairwise intersection areas of rotated BEV boxes given their
    corners: c1 (M, 4, 2), c2 (N, 4, 2) -> (M, N)."""
    M, N = c1.shape[0], c2.shape[0]
    p1 = c1[:, None].expand(M, N, 4, 2).reshape(M * N, 4, 2)
    p2 = c2[None].expand(M, N, 4, 2).reshape(M * N, 4, 2)
    pts = torch.cat([p1, p1[:, :1].expand(-1, V_MAX - 4, 2)], dim=1)
    count = torch.full((M * N,), 4, dtype=torch.long, device=c1.device)
    for i in range(4):
        pts, count = _clip_poly(pts, count, p2[:, i], p2[:, (i + 1) % 4])
    keep = (torch.arange(V_MAX, device=c1.device)[None, :]
            < count[:, None])[..., None]
    pts = torch.where(keep, pts, pts[:, :1])
    return _polygon_area(pts).view(M, N)


def _z_overlap(bboxes1, bboxes2):
    z1lo = bboxes1[:, 2] - bboxes1[:, 5] / 2
    z1hi = bboxes1[:, 2] + bboxes1[:, 5] / 2
    z2lo = bboxes2[:, 2] - bboxes2[:, 5] / 2
    z2hi = bboxes2[:, 2] + bboxes2[:, 5] / 2
    return (torch.minimum(z1hi[:, None], z2hi[None, :])
            - torch.maximum(z1lo[:, None], z2lo[None, :])).clamp(min=0.0)


def _overlaps_from_bev(inter_bev, bboxes1, bboxes2, mode):
    if mode == "bev":
        return inter_bev
    zo = _z_overlap(bboxes1, bboxes2)
    inter = inter_bev * zo
    v1 = bboxes1[:, 3] * bboxes1[:, 4] * bboxes1[:, 5]
    v2 = bboxes2[:, 3] * bboxes2[:, 4] * bboxes2[:, 5]
    if mode == "iou":
        union = v1[:, None] + v2[None, :] - inter
    else:
        union = v1[:, None] * torch.ones_like(v2)[None, :]
    return inter / union.clamp(min=1e-8)


def bbox_overlaps_3d_plain(bboxes1, bboxes2, mode: str = "iou"):
    """The same function as `bbox_overlaps_3d` in plain PyTorch (mode
    'bev' gives the BEV intersection areas)."""
    inter_bev = rotated_overlaps_bev_plain(box_corners_bev(bboxes1),
                                           box_corners_bev(bboxes2))
    return _overlaps_from_bev(inter_bev, bboxes1, bboxes2, mode)


def bbox_overlaps_3d(bboxes1, bboxes2, mode: str = "iou", *,
                     skipped: Optional[torch.Tensor] = None):
    """(M, 7) x (N, 7) float32 -> (M, N) exact rotated 3D IoU or IoF
    (iou3d_calculator.py:127-150): rotated BEV overlap times z-extent
    overlap, over max(union, 1e-8). mode 'bev' returns the BEV
    intersection areas.

    skipped: optional one-element int64 tensor on the boxes' CUDA device;
    the kernel adds to it the pairs its pre-test answered without
    clipping. The plain version (CPU tensors) clips every pair and leaves
    it as it is."""
    global launches
    if mode not in _MODES:
        raise ValueError(mode)
    if bboxes1.dtype != torch.float32 or bboxes2.dtype != torch.float32:
        raise TypeError("iou3d: boxes must be float32")
    if (bboxes1.dim() != 2 or bboxes2.dim() != 2 or bboxes1.shape[1] < 7
            or bboxes2.shape[1] < 7):
        raise ValueError(f"iou3d: boxes must be (M, 7+) and (N, 7+), got "
                         f"{tuple(bboxes1.shape)}, {tuple(bboxes2.shape)}")
    if bboxes1.device != bboxes2.device:
        raise ValueError("iou3d: all tensors must be on one device")
    if skipped is not None and (skipped.dtype != torch.int64
                                or skipped.numel() != 1
                                or skipped.device != bboxes1.device):
        raise ValueError("iou3d: skipped must be one int64 on the boxes' device")
    if bboxes1.device.type == "cpu":
        return bbox_overlaps_3d_plain(bboxes1, bboxes2, mode)
    if bboxes1.device.type != "cuda":
        raise ValueError(f"iou3d: unsupported device {bboxes1.device}")
    if torch.is_grad_enabled() and (bboxes1.requires_grad
                                    or bboxes2.requires_grad):
        raise RuntimeError(
            "iou3d: the CUDA kernel has no backward; call it under "
            "torch.no_grad() or on detached boxes (bbox_overlaps_3d_plain "
            "differentiates)")
    M, N = bboxes1.shape[0], bboxes2.shape[0]
    out = torch.empty(M, N, dtype=torch.float32, device=bboxes1.device)
    if out.numel() == 0:  # nothing to launch
        return out
    b1, b2 = (b if b.stride(1) == 1 else b.contiguous()
              for b in (bboxes1, bboxes2))
    err = _lib().box_overlaps_3d(
        b1.data_ptr(), b1.stride(0), b2.data_ptr(), b2.stride(0),
        out.data_ptr(), M, N, _MODES[mode], PRETEST_MARGIN,
        None if skipped is None else skipped.data_ptr(),
        torch.cuda.current_stream(bboxes1.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"iou3d kernel launch failed: cudaError {err}")
    launches += 1
    return out


def rotated_overlap_bev(box1, box2):
    """Exact intersection area of two rotated BEV boxes (7-d each)."""
    return bbox_overlaps_3d(box1[None], box2[None], mode="bev")[0, 0]
