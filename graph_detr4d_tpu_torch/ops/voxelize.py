"""K6: pillar voxelization of a point cloud.

Counterpart of graph_detr4d_tpu/ops/voxelize.py (`pillar_indices`,
`pillar_center_offsets`, `pillar_scatter`): the dense PointPillars scatter
that stands in for mmdet3d's hard voxelizer (a hard voxelizer with
unlimited points per voxel and max pooling gives exactly this result).
Every point gets a flat BEV cell id, x along the grid's first axis; a
point that is masked out or outside the range in x, y or z goes to a trash
cell H*W that contributes to no real pillar.

Three launch sites, each with a plain PyTorch version for CPU tensors:
  * `pillar_features` (one cooperative kernel of `csrc/voxelize.cu`):
    cell ids and the augmented point rows [point..., dx_c, dy_c, dx_m,
    dy_m, dz_m], offsets from the pillar's centre and from the mean xyz of
    the points sharing it (the kernel sums a cell's coordinates as exact
    integers, so its rows do not depend on the points' order);
  * `pillar_scatter` (kernel C): the per-cell max of per-point features,
    as a dense (B, H, W, C) grid with empty cells 0 (the JAX op's
    `reduce="max"`, the only reduction a model path uses), differentiable
    in the features;
  * `pillar_scatter_backward` (one cooperative kernel): that max's
    gradient, the backward of `pillar_scatter`'s autograd Function.

Batched over a leading sample axis (the JAX op's vmap). On CUDA tensors
`pillar_features` has no backward and raises when asked for one (the plain
version differentiates the rows in the points; no model path needs it).
"""

import ctypes
import functools
import math
from typing import Sequence, Tuple

import torch

from . import build

# kernel launches made by pillar_features, pillar_scatter and
# pillar_scatter_backward (plain ints; chip_smoke.py resets them before
# driving the main path and reads them after)
launches = 0
scatter_launches = 0
scatter_backward_launches = 0

# the widest point row pillar_features' kernel takes: it stages a block's
# 256 rows of F + 5 floats in shared memory, within the 48 KB a block gets
# without opting in
MAX_FEATURES = 42


@functools.cache
def _lib():
    lib = build.load("voxelize")
    lib.pillar_features.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.pillar_features.restype = ctypes.c_int
    lib.pillar_scatter_max.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.pillar_scatter_max.restype = ctypes.c_int
    lib.pillar_scatter_max_backward.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.pillar_scatter_max_backward.restype = ctypes.c_int
    return lib


def _geometry(pc_range, grid_hw, device):
    """float32 scalars of the grid, as the JAX op gets them: its cell size
    is a Python float, a compile-time constant, so under jit XLA divides
    by multiplying with the constant's float32 reciprocal (eager JAX
    divides; every JAX entry point runs jitted). Returns 0-dim tensors
    (x0, y0, z0, z1, sx, sy, rx, ry): tensor-by-tensor arithmetic, so no
    scalar fast path reorders it."""
    H, W = grid_hw
    sx = (pc_range[3] - pc_range[0]) / H
    sy = (pc_range[4] - pc_range[1]) / W
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    one = f32(1.0)
    return (f32(pc_range[0]), f32(pc_range[1]), f32(pc_range[2]),
            f32(pc_range[5]), f32(sx), f32(sy), one / f32(sx), one / f32(sy))


@functools.lru_cache(maxsize=16)
def _kernel_geometry(pc_range, grid_hw):
    """pillar_features' scalar arguments for a grid: the float32 values of
    `_geometry` in the kernel's order (x0, y0, z0, z1, rx, ry, sx, sy), as
    Python floats, then for x, y and z the exponent e with every in-range
    coordinate's magnitude below 2^e (the kernel scales the axis into its
    exact integer cell sums by 2^(62 - e - bits of P))."""
    H, W = grid_hw
    x0, y0, z0, z1, sx, sy, rx, ry = (
        t.item() for t in _geometry(pc_range, grid_hw, "cpu"))

    def exponent(lo, hi):
        return math.ceil(math.log2(max(abs(lo), abs(hi), 2.0 ** -30)))

    return (x0, y0, z0, z1, rx, ry, sx, sy,
            exponent(x0, x0 + (H + 1) * sx), exponent(y0, y0 + (W + 1) * sy),
            exponent(z0, z1))


def pillar_indices_plain(points, mask, pc_range, grid_hw):
    """Flat cell id per point, int32 (B, P); masked or out-of-range points
    -> H*W (the JAX op's in-bounds mask is ids < H*W)."""
    H, W = grid_hw
    x0, y0, z0, z1, _, _, rx, ry = _geometry(pc_range, grid_hw, points.device)
    fx = torch.floor((points[..., 0] - x0) * rx)
    fy = torch.floor((points[..., 1] - y0) * ry)
    z = points[..., 2]
    inb = ((fx >= 0) & (fx < H) & (fy >= 0) & (fy < W) & (z >= z0) & (z < z1)
           & (mask > 0))
    ix = fx.clamp(0, H - 1).to(torch.int32)
    iy = fy.clamp(0, W - 1).to(torch.int32)
    return torch.where(inb, ix * W + iy, torch.full_like(ix, H * W))


def _segments(ids, n):
    """Flat segment index per point over a (B, n) segment table."""
    B = ids.shape[0]
    off = torch.arange(B, device=ids.device)[:, None] * n
    return (ids.long() + off).reshape(-1)


def pillar_center_offsets_plain(points, ids, pc_range, grid_hw):
    """[points..., dx_c, dy_c, dx_m, dy_m, dz_m] (B, P, F + 5): offsets
    from the pillar's geometric centre (taken from the id, so trash points
    get them too) and from the mean xyz of the points sharing the cell
    (float64 sums, rounded to float32 before the division: the kernel's
    exact integer sums round to the same float32)."""
    H, W = grid_hw
    x0, y0, _, _, sx, sy, _, _ = _geometry(pc_range, grid_hw, points.device)
    ix, iy = ids // W, ids % W
    dxc = points[..., 0] - (x0 + (ix.float() + 0.5) * sx)
    dyc = points[..., 1] - (y0 + (iy.float() + 0.5) * sy)
    B, P = ids.shape
    n = H * W + 1
    seg = _segments(ids, n)
    xyz = points[..., :3]
    sums = torch.zeros(B * n, 3, dtype=torch.float64, device=points.device)
    sums.index_add_(0, seg, xyz.reshape(-1, 3).double())
    counts = torch.bincount(seg, minlength=B * n).float().clamp(min=1.0)
    mean = sums.float() / counts[:, None]
    dm = xyz - mean[seg].view(B, P, 3)
    return torch.cat([points, dxc[..., None], dyc[..., None], dm], dim=-1)


def pillar_features_plain(points, mask, pc_range, grid_hw):
    ids = pillar_indices_plain(points, mask, pc_range, grid_hw)
    return ids, pillar_center_offsets_plain(points, ids, pc_range, grid_hw)


def _check_points(points, mask):
    if points.dtype != torch.float32:
        raise TypeError(f"voxelize: points must be float32, got {points.dtype}")
    if points.dim() != 3 or points.shape[-1] < 3:
        raise ValueError(
            f"voxelize: points must be (B, P, F >= 3), got {tuple(points.shape)}")
    if tuple(mask.shape) != tuple(points.shape[:2]):
        raise ValueError(f"voxelize: mask {tuple(mask.shape)} != "
                         f"{tuple(points.shape[:2])}")
    if mask.device != points.device:
        raise ValueError("voxelize: all tensors must be on one device")


def pillar_features(
    points: torch.Tensor,
    mask: torch.Tensor,
    pc_range: Sequence[float],
    grid_hw: Tuple[int, int],
):
    """Cell ids and augmented point rows of a batch of point clouds.

    Args:
      points: (B, P, F) float32, xyz first.
      mask: (B, P) validity (> 0 is valid), any dtype.
      pc_range: (x0, y0, z0, x1, y1, z1).
      grid_hw: (H, W) BEV cells, x along H.

    Returns (ids (B, P) int32 in [0, H*W], H*W = trash;
    aug (B, P, F + 5) float32).
    """
    global launches
    _check_points(points, mask)
    if points.device.type == "cpu":
        return pillar_features_plain(points, mask, pc_range, grid_hw)
    if points.device.type != "cuda":
        raise ValueError(f"voxelize: unsupported device {points.device}")
    if torch.is_grad_enabled() and points.requires_grad:
        raise RuntimeError(
            "voxelize: pillar_features' CUDA kernel has no backward; call it "
            "under torch.no_grad() or on detached points "
            "(pillar_features_plain differentiates)")
    H, W = grid_hw
    B, P, F = points.shape
    if F > MAX_FEATURES:
        raise ValueError(f"voxelize: the kernel takes at most {MAX_FEATURES} "
                         f"features a point, got {F}")
    points = points.contiguous()
    # the kernel reads float32 and tests > 0 itself
    mask = (mask if mask.dtype == torch.float32 else (mask > 0).float()).contiguous()
    ids = torch.empty(B, P, dtype=torch.int32, device=points.device)
    aug = torch.empty(B, P, F + 5, dtype=torch.float32, device=points.device)
    if ids.numel() == 0:  # nothing to launch
        return ids, aug
    # the kernel's cell table: (B, H*W + 1) records of 32 bytes
    table = torch.empty(B, H * W + 1, 4, dtype=torch.int64, device=points.device)
    err = _lib().pillar_features(
        points.data_ptr(), mask.data_ptr(), ids.data_ptr(), aug.data_ptr(),
        table.data_ptr(), B, P, F, H, W,
        *_kernel_geometry(tuple(pc_range), (H, W)),
        torch.cuda.current_stream(points.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"pillar_features kernel launch failed: cudaError {err}")
    launches += 1
    return ids, aug


def pillar_scatter_plain(feats, ids, grid_hw):
    """The same function as `pillar_scatter`: `scatter_reduce_` (amax)
    over a -inf grid."""
    H, W = grid_hw
    B, P, C = feats.shape
    n = H * W + 1
    seg = _segments(ids, n)
    out = torch.full((B * n, C), float("-inf"), dtype=feats.dtype,
                     device=feats.device)
    out.scatter_reduce_(0, seg[:, None].expand(-1, C), feats.reshape(-1, C),
                        "amax")
    out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    return out.view(B, n, C)[:, : H * W].reshape(B, H, W, C)


def _check_scatter(feats, ids):
    if feats.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError("voxelize: feats must be float32 and ids int32")
    if feats.dim() != 3 or tuple(ids.shape) != tuple(feats.shape[:2]):
        raise ValueError(f"voxelize: feats {tuple(feats.shape)} and ids "
                         f"{tuple(ids.shape)} do not match")
    if ids.device != feats.device:
        raise ValueError("voxelize: all tensors must be on one device")
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"voxelize: unsupported device {feats.device}")


def pillar_scatter(
    feats: torch.Tensor,
    ids: torch.Tensor,
    grid_hw: Tuple[int, int],
) -> torch.Tensor:
    """Per-cell max of point features into a dense BEV grid, differentiable
    in feats (each cell's gradient goes to the points that hold its max,
    split evenly between ties; cells whose max is not finite pass none).

    Args:
      feats: (B, P, C) float32.
      ids: (B, P) int32 cell ids from `pillar_features` (H*W = trash, left
        out).

    Returns (B, H, W, C) float32; cells no point reaches, and cells whose
    maximum is not finite, are 0.
    """
    _check_scatter(feats, ids)
    return _PillarScatterFunction.apply(feats, ids, tuple(grid_hw))


class _PillarScatterFunction(torch.autograd.Function):
    """The max-scatter with `pillar_scatter_backward` as its gradient, on
    either device (autograd through `pillar_scatter_plain` would give NaN
    to the points of a cell whose max is NaN, where jax.vjp gives 0)."""

    @staticmethod
    def forward(ctx, feats, ids, grid_hw):
        global scatter_launches
        H, W = grid_hw
        B, P, C = feats.shape
        ctx.grid_hw = grid_hw
        if feats.device.type == "cpu":
            out = pillar_scatter_plain(feats, ids, grid_hw)
            ctx.save_for_backward(feats, ids, out)
            return out
        feats, ids = feats.contiguous(), ids.contiguous()
        out = torch.empty(B, H, W, C, dtype=torch.float32, device=feats.device)
        ctx.save_for_backward(feats, ids, out)
        if out.numel() == 0:  # nothing to launch
            return out
        err = _lib().pillar_scatter_max(
            feats.data_ptr(), ids.data_ptr(), out.data_ptr(), B, P, C, H * W,
            torch.cuda.current_stream(feats.device).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"pillar_scatter kernel launch failed: cudaError {err}")
        scatter_launches += 1
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        feats, ids, out = ctx.saved_tensors
        return (pillar_scatter_backward(feats, ids, out, grad_out, ctx.grid_hw),
                None, None)


def pillar_scatter_backward_plain(feats, ids, grad_out, grid_hw):
    """The same function as `pillar_scatter_backward` (it recomputes the
    max): jax.vjp of the JAX op. Each (cell, channel)'s gradient goes to
    the points whose value equals the cell's max, divided by their count
    as autograd of `scatter_reduce_` 'amax' divides it; a cell whose max is
    NaN or +inf (written 0), and the trash cell, pass none."""
    H, W = grid_hw
    B, P, C = feats.shape
    n = H * W + 1
    seg = _segments(ids, n)
    f = feats.reshape(-1, C)
    top = torch.full((B * n, C), float("-inf"), dtype=f.dtype, device=f.device)
    top = top.scatter_reduce_(0, seg[:, None].expand(-1, C), f, "amax")[seg]
    win = (f == top) & torch.isfinite(top)
    count = torch.zeros(B * n, C, dtype=f.dtype, device=f.device)
    count.index_add_(0, seg, win.to(f.dtype))
    g = torch.cat([grad_out.reshape(B, H * W, C),
                   grad_out.new_zeros(B, 1, C)], 1).reshape(B * n, C)
    share = g[seg] / count[seg].clamp(min=1.0)
    return torch.where(win, share, torch.zeros_like(share)).view(B, P, C)


def pillar_scatter_backward(feats, ids, out, grad_out, grid_hw):
    """Gradient of `pillar_scatter` for feats (B, P, C) float32, given its
    result `out` for these inputs (B, H, W, C) and grad_out of that shape.
    One cooperative kernel for CUDA tensors (the winner counts zeroed, a
    pass that counts each cell's winners and marks each point's, then the
    gradient pass),
    `pillar_scatter_backward_plain` for CPU tensors."""
    global scatter_backward_launches
    _check_scatter(feats, ids)
    H, W = grid_hw
    B, P, C = feats.shape
    for name, t in (("out", out), ("grad_out", grad_out)):
        if tuple(t.shape) != (B, H, W, C) or t.dtype != torch.float32:
            raise ValueError(f"voxelize: {name} must be float32 {(B, H, W, C)}")
        if t.device != feats.device:
            raise ValueError("voxelize: all tensors must be on one device")
    if feats.device.type == "cpu":
        return pillar_scatter_backward_plain(feats, ids, grad_out, grid_hw)
    # the kernel reads and writes a row two columns at a time: 8-byte
    # aligned data (a view that starts at an odd element is copied)
    feats, out, grad_out = (t.contiguous() if t.data_ptr() % 8 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (feats, out, grad_out))
    ids = ids.contiguous()
    grad_feats = torch.empty_like(feats)  # every element written
    if grad_feats.numel() == 0 or out.numel() == 0:  # nothing to launch
        return grad_feats.zero_()
    # the kernel's winner counts per (cell, channel), padded to an even
    # count, then two mask words per point and group of 64 channels
    cells = B * H * W * C
    scratch = torch.empty(cells + cells % 2 + 2 * B * P * -(-C // 64),
                          dtype=torch.int32, device=feats.device)
    err = _lib().pillar_scatter_max_backward(
        feats.data_ptr(), ids.data_ptr(), out.data_ptr(), grad_out.data_ptr(),
        grad_feats.data_ptr(), scratch.data_ptr(), B, P, C, H * W,
        torch.cuda.current_stream(feats.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"pillar_scatter backward kernel launch failed: cudaError {err}")
    scatter_backward_launches += 1
    return grad_feats
