"""K1: multi-scale deformable attention (MSDA), forward and backward.

Counterpart of graph_detr4d_tpu/ops/msda.py::multi_scale_deformable_attention.
Semantics (mmcv's MultiScaleDeformableAttnFunction): sampling locations
are in [0, 1] per level, pixel coordinates follow `align_corners=False`
(x_px = x * W - 0.5), bilinear with zero padding outside; the output is
the attention-weighted sum over levels and points, per head.

`msda_forward` is differentiable in value, loc and attn. For a CUDA
tensor it runs the forward kernel of `csrc/msda.cu` inside an autograd
Function whose backward is the backward kernel (`msda_backward`); for a
CPU tensor it runs `msda_forward_plain`, per-level `F.grid_sample`, which
autograd differentiates (`msda_backward_plain`). The backward kernels write
grad_value by tiles of the value maps, once, in value's dtype. Values use the mmcv
layout: all levels flattened into one (BN, sum_l H_l*W_l, heads, hd)
buffer, levels in order.
"""

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import build

# kernel launches made by msda_forward and msda_backward (plain ints;
# chip_smoke.py resets them before driving the main path and reads them
# after)
launches = 0
backward_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    lib = build.load("msda")
    lib.msda_forward.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.msda_forward.restype = ctypes.c_int
    lib.msda_backward_workspace.argtypes = [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.msda_backward_workspace.restype = ctypes.c_longlong
    lib.msda_backward.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_longlong] + [ctypes.c_int] * 8 + [
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.msda_backward.restype = ctypes.c_int
    lib.msda_max_hlp.argtypes = []
    lib.msda_max_hlp.restype = ctypes.c_int
    return lib


def _check(value, spatial_shapes, loc, attn, index):
    if value.dtype not in _DTYPES:
        raise TypeError(f"msda: value dtype {value.dtype} not in {list(_DTYPES)}")
    if loc.dtype != torch.float32 or attn.dtype != torch.float32:
        raise TypeError("msda: loc and attn must be float32")
    if value.dim() != 4 or loc.dim() != 6 or attn.dim() != 5:
        raise ValueError(
            "msda: expected value (BN, S, heads, hd), loc (BN, Q, heads, L, "
            "P, 2), attn (BN, Q, heads, L, P); got "
            f"{tuple(value.shape)}, {tuple(loc.shape)}, {tuple(attn.shape)}"
        )
    BN, S, heads, _ = value.shape
    L = len(spatial_shapes)
    if tuple(loc.shape[:5]) != tuple(attn.shape) or loc.shape[-1] != 2:
        raise ValueError(
            f"msda: loc {tuple(loc.shape)} does not match attn "
            f"{tuple(attn.shape)}"
        )
    if loc.shape[0] != BN or loc.shape[2] != heads or loc.shape[3] != L:
        raise ValueError(
            f"msda: loc {tuple(loc.shape)} does not match value "
            f"{tuple(value.shape)} with {L} levels"
        )
    if sum(h * w for h, w in spatial_shapes) != S:
        raise ValueError(
            f"msda: levels {list(spatial_shapes)} do not sum to S={S}"
        )
    if index is not None:
        if index.dtype != torch.int64 or index.dim() != 2:
            raise TypeError("msda: index must be an int64 (BN, R) tensor")
        if index.shape[0] != BN:
            raise ValueError(f"msda: index {tuple(index.shape)} vs BN={BN}")
    tensors = [value, loc, attn] + ([index] if index is not None else [])
    if any(t.device != value.device for t in tensors):
        raise ValueError("msda: all tensors must be on one device")


def msda_forward(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    loc: torch.Tensor,
    attn: torch.Tensor,
    index: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-scale deformable attention, differentiable in value, loc and
    attn (not in index).

    Args:
      value: (BN, S, heads, hd) float32 or bfloat16, levels flattened in
        order, S = sum of H_l * W_l.
      spatial_shapes: L pairs (H_l, W_l) of Python ints.
      loc: (BN, Q, heads, L, P, 2) float32 sampling locations (x, y) in
        [0, 1].
      attn: (BN, Q, heads, L, P) float32 weights (softmax and masks already
        applied by the caller).
      index: optional (BN, R) int64 query ids in [0, Q), distinct within a
        row: output row r of bn samples query index[bn, r]. None means
        every query, R = Q.

    Returns (BN, R, heads * hd) in value's dtype.
    """
    _check(value, spatial_shapes, loc, attn, index)
    if value.device.type == "cpu":
        return msda_forward_plain(value, spatial_shapes, loc, attn, index)
    if value.device.type != "cuda":
        raise ValueError(f"msda: unsupported device {value.device}")
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    return _MSDAFunction.apply(value, loc, attn, index, shapes)


class _MSDAFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, loc, attn, index, shapes):
        ctx.save_for_backward(value, loc, attn, index)
        ctx.shapes = shapes
        return _launch_forward(value, shapes, loc, attn, index)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        value, loc, attn, index = ctx.saved_tensors
        grads = msda_backward(value, ctx.shapes, loc, attn, grad_out, index)
        return (*grads, None, None)


def _contiguous(**tensors):
    for name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"msda: {name} must be contiguous")


def _level_hw(spatial_shapes):
    L = len(spatial_shapes)
    return (ctypes.c_int * (2 * L))(*[int(v) for s in spatial_shapes for v in s])


def _launch_forward(value, spatial_shapes, loc, attn, index):
    global launches
    _contiguous(value=value, loc=loc, attn=attn, index=index)
    lib = _lib()
    BN, S, heads, hd = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    if heads * L * P > lib.msda_max_hlp():
        raise ValueError(
            f"msda: heads*L*P = {heads * L * P} exceeds the kernel's "
            f"{lib.msda_max_hlp()}"
        )
    R = Q if index is None else index.shape[1]
    out = torch.empty(BN, R, heads * hd, dtype=value.dtype,
                      device=value.device)
    if out.numel() == 0:  # nothing to launch
        return out
    err = lib.msda_forward(
        value.data_ptr(), loc.data_ptr(), attn.data_ptr(),
        None if index is None else index.data_ptr(), out.data_ptr(),
        BN, S, Q, R, heads, hd, L, P, _level_hw(spatial_shapes),
        _DTYPES[value.dtype],
        torch.cuda.current_stream(value.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"msda kernel launch failed: cudaError {err}")
    launches += 1
    return out


def msda_backward(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    loc: torch.Tensor,
    attn: torch.Tensor,
    grad_out: torch.Tensor,
    index: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of `msda_forward` for (value, loc, attn), given grad_out
    (BN, R, heads * hd). grad_value comes in value's dtype, grad_loc and
    grad_attn in float32. The backward kernels for CUDA tensors (grad_value
    written once in value's dtype, no fp32 copy of it; a workspace of a
    few MB for the binned samples), `msda_backward_plain` for CPU
    tensors."""
    global backward_launches
    _check(value, spatial_shapes, loc, attn, index)
    R = loc.shape[1] if index is None else index.shape[1]
    BN, S, heads, hd = value.shape
    if tuple(grad_out.shape) != (BN, R, heads * hd):
        raise ValueError(
            f"msda: grad_out {tuple(grad_out.shape)} != {(BN, R, heads * hd)}")
    if value.device.type == "cpu":
        return msda_backward_plain(value, spatial_shapes, loc, attn, grad_out,
                                   index)
    if value.device.type != "cuda":
        raise ValueError(f"msda: unsupported device {value.device}")
    grad_out = grad_out.to(value.dtype).contiguous()
    _contiguous(value=value, loc=loc, attn=attn, index=index)
    # zero for the queries the index list leaves out and for samples outside
    # every level
    grad_loc = torch.zeros_like(loc)
    grad_attn = torch.zeros_like(attn)
    if grad_out.numel() == 0:  # nothing to launch
        return torch.zeros_like(value), grad_loc, grad_attn
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    lib = _lib()
    level_hw = _level_hw(spatial_shapes)
    ws_bytes = lib.msda_backward_workspace(BN, S, R, heads, hd, L, P, level_hw)
    if ws_bytes <= 0:
        raise ValueError(f"msda backward: head width {hd} or the sample "
                         "count is beyond the kernel's tiles")
    workspace = torch.empty(ws_bytes, dtype=torch.uint8, device=value.device)
    grad_value = torch.empty_like(value)  # every element written
    err = lib.msda_backward(
        value.data_ptr(), loc.data_ptr(), attn.data_ptr(),
        None if index is None else index.data_ptr(), grad_out.data_ptr(),
        grad_value.data_ptr(), grad_loc.data_ptr(), grad_attn.data_ptr(),
        workspace.data_ptr(), ws_bytes,
        BN, S, Q, R, heads, hd, L, P, level_hw, _DTYPES[value.dtype],
        torch.cuda.current_stream(value.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"msda backward kernel launch failed: cudaError {err}")
    backward_launches += 1
    return grad_value, grad_loc, grad_attn


def msda_backward_plain(value, spatial_shapes, loc, attn, grad_out,
                        index=None):
    """The same function as `msda_backward`: autograd through
    `msda_forward_plain`."""
    with torch.enable_grad():
        v, l, a = (t.detach().requires_grad_() for t in (value, loc, attn))
        out = msda_forward_plain(v, spatial_shapes, l, a, index)
        return torch.autograd.grad(out, (v, l, a), grad_out.to(out.dtype))


def msda_forward_plain(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    loc: torch.Tensor,
    attn: torch.Tensor,
    index: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The same function as `msda_forward` in plain PyTorch: per-level
    `F.grid_sample` (align_corners=False, zero padding), as the JAX
    package's torch oracle (tests/test_golden_torch.py:101-150). Computes
    in float64, so that grid_sample's normalise / unnormalise round trip
    moves no sample, and returns value's dtype."""
    if index is not None:
        rows = torch.arange(loc.shape[0], device=loc.device)[:, None]
        loc, attn = loc[rows, index], attn[rows, index]
    BN, S, heads, hd = value.shape
    R, P = loc.shape[1], loc.shape[4]
    out = torch.zeros(BN * heads, hd, R, dtype=torch.float64,
                      device=value.device)
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        v = value[:, start:start + H * W].double()
        start += H * W
        v = v.permute(0, 2, 3, 1).reshape(BN * heads, hd, H, W)
        grid = 2.0 * loc[:, :, :, lvl].double() - 1.0  # (BN, R, heads, P, 2)
        grid = grid.permute(0, 2, 1, 3, 4).reshape(BN * heads, R, P, 2)
        s = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=False)  # (BN*heads, hd, R, P)
        w = attn[:, :, :, lvl].double().permute(0, 2, 1, 3)
        w = w.reshape(BN * heads, 1, R, P)
        out += (s * w).sum(-1)
    out = out.view(BN, heads, hd, R).permute(0, 3, 1, 2)
    return out.reshape(BN, R, heads * hd).to(value.dtype)
