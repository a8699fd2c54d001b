"""K2: modulated deformable convolution (DCNv2), forward and backward.

Counterpart of graph_detr4d_tpu/ops/deform_conv.py::deform_conv2d, with
mmcv's ModulatedDeformConv2d semantics: per output pixel and 3x3 tap, a
learned (dy, dx) offset shifts the tap's sampling point, the input is
sampled bilinearly with zero padding, scaled by the modulation mask, and
contracted with the conv weight.

`deform_im2col` builds the sampled column tile (B*Ho*Wo, 9*Cin),
differentiable in x, offsets and mask: for a CUDA tensor the forward
kernel of `csrc/deform_conv.cu` inside an autograd Function whose
backward is that file's col2im kernel (`deform_col2im`); for a CPU tensor
`deform_im2col_plain` (per-tap `F.grid_sample`), which autograd
differentiates. `deform_conv2d` contracts the tile with the (9*Cin, Cout)
weight in one matrix product, whose autograd keeps the tile for the
weight gradient.

K3, the int8 variant (`variant="int8"`, counterpart of
graph_detr4d_tpu/ops/deform_conv.py::_deform_conv_int8): the input is
quantized to an int8 table at per-(image, channel) amax scales and the
taps are gathered from it and dequantized (`deform_im2col_int8`, the
`csrc/deform_conv.cu` kernels for a CUDA tensor, `deform_im2col_int8_plain`
for a CPU one). Its gradient is straight-through, the exact gradient of
the fp conv (K2's col2im for x, offsets and mask, and the fp column tile,
recomputed, for the weight), as the JAX op's `_int8_bwd`. Like the JAX op,
it applies only where the input's padded grid has more than
ONEHOT_MAX_PIXELS pixels; smaller grids stay exact (`select_variant`).
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build

# kernel launches made by deform_im2col, deform_col2im and
# deform_im2col_int8 (plain ints; chip_smoke.py resets them before driving
# the main path and reads them after)
launches = 0
backward_launches = 0
int8_launches = 0

KERNEL_SIZE = 3
TAPS = KERNEL_SIZE * KERNEL_SIZE
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# at or below this padded-grid pixel count the JAX op samples exactly,
# whatever the variant (graph_detr4d_tpu/ops/deform_conv.py:27, 111)
ONEHOT_MAX_PIXELS = 1536


@functools.cache
def _lib():
    lib = build.load("deform_conv")
    lib.deform_im2col.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p
    ]
    lib.deform_im2col.restype = ctypes.c_int
    lib.deform_col2im.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p
    ]
    lib.deform_col2im.restype = ctypes.c_int
    lib.deform_im2col_int8.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.deform_im2col_int8.restype = ctypes.c_int
    return lib


def output_size(size: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - KERNEL_SIZE) // stride + 1


def _check(x, offsets, mask, stride, padding):
    if x.dtype not in _DTYPES:
        raise TypeError(f"deform_conv: dtype {x.dtype} not in {list(_DTYPES)}")
    if offsets.dtype != x.dtype or mask.dtype != x.dtype:
        raise TypeError("deform_conv: x, offsets and mask must share a dtype")
    if x.dim() != 4:
        raise ValueError(f"deform_conv: x must be (B, H, W, Cin), got {tuple(x.shape)}")
    B, H, W, _ = x.shape
    Ho, Wo = output_size(H, stride, padding), output_size(W, stride, padding)
    if tuple(offsets.shape) != (B, Ho, Wo, TAPS, 2):
        raise ValueError(
            f"deform_conv: offsets {tuple(offsets.shape)} != "
            f"{(B, Ho, Wo, TAPS, 2)}"
        )
    if tuple(mask.shape) != (B, Ho, Wo, TAPS):
        raise ValueError(
            f"deform_conv: mask {tuple(mask.shape)} != {(B, Ho, Wo, TAPS)}"
        )
    if offsets.device != x.device or mask.device != x.device:
        raise ValueError("deform_conv: all tensors must be on one device")
    return B, H, W, Ho, Wo


def deform_im2col(
    x: torch.Tensor,
    offsets: torch.Tensor,
    mask: torch.Tensor,
    stride: int = 1,
    padding: int = 1,
) -> torch.Tensor:
    """Sampled, mask-scaled 3x3 columns of a modulated deformable conv,
    differentiable in x, offsets and mask.

    Args:
      x: (B, H, W, Cin) float32 or bfloat16, channels-last.
      offsets: (B, Ho, Wo, 9, 2) per-tap (dy, dx), x's dtype.
      mask: (B, Ho, Wo, 9) modulation (already sigmoid-ed), x's dtype.

    Returns (B*Ho*Wo, 9*Cin) in x's dtype, tap-major: column k*Cin + c is
    channel c sampled at tap k = ky*3 + kx.
    """
    _check(x, offsets, mask, stride, padding)
    if x.device.type == "cpu":
        return deform_im2col_plain(x, offsets, mask, stride, padding)
    if x.device.type != "cuda":
        raise ValueError(f"deform_conv: unsupported device {x.device}")
    return _DeformIm2col.apply(x, offsets, mask, stride, padding)


class _DeformIm2col(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offsets, mask, stride, padding):
        ctx.save_for_backward(x, offsets, mask)
        ctx.conv = (stride, padding)
        return _launch_forward(x, offsets, mask, stride, padding)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_cols):
        x, offsets, mask = ctx.saved_tensors
        grads = deform_col2im(x, offsets, mask, grad_cols, *ctx.conv)
        return (*grads, None, None)


def _contiguous(**tensors):
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"deform_conv: {name} must be contiguous")


def _launch_forward(x, offsets, mask, stride, padding):
    global launches
    _contiguous(x=x, offsets=offsets, mask=mask)
    B, H, W, Cin = x.shape
    Ho, Wo = offsets.shape[1:3]
    cols = torch.empty(B * Ho * Wo, TAPS * Cin, dtype=x.dtype, device=x.device)
    if cols.numel() == 0:  # nothing to launch
        return cols
    err = _lib().deform_im2col(
        x.data_ptr(), offsets.data_ptr(), mask.data_ptr(), cols.data_ptr(),
        B, H, W, Cin, Ho, Wo, stride, padding, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"deform_im2col kernel launch failed: cudaError {err}")
    launches += 1
    return cols


def deform_col2im(
    x: torch.Tensor,
    offsets: torch.Tensor,
    mask: torch.Tensor,
    grad_cols: torch.Tensor,
    stride: int = 1,
    padding: int = 1,
):
    """Gradients of `deform_im2col` for (x, offsets, mask), given grad_cols
    (B*Ho*Wo, 9*Cin), all in x's dtype. The backward kernel for CUDA
    tensors, `deform_col2im_plain` for CPU tensors."""
    global backward_launches
    B, H, W, Ho, Wo = _check(x, offsets, mask, stride, padding)
    Cin = x.shape[-1]
    if tuple(grad_cols.shape) != (B * Ho * Wo, TAPS * Cin):
        raise ValueError(
            f"deform_conv: grad_cols {tuple(grad_cols.shape)} != "
            f"{(B * Ho * Wo, TAPS * Cin)}")
    if x.device.type == "cpu":
        return deform_col2im_plain(x, offsets, mask, grad_cols, stride,
                                   padding)
    if x.device.type != "cuda":
        raise ValueError(f"deform_conv: unsupported device {x.device}")
    grad_cols = grad_cols.to(x.dtype).contiguous()
    _contiguous(x=x, offsets=offsets, mask=mask)
    grad_x = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    grad_off = torch.zeros(offsets.shape, dtype=torch.float32, device=x.device)
    grad_mask = torch.zeros(mask.shape, dtype=torch.float32, device=x.device)
    if grad_mask.numel() > 0:
        err = _lib().deform_col2im(
            x.data_ptr(), offsets.data_ptr(), mask.data_ptr(),
            grad_cols.data_ptr(), grad_x.data_ptr(), grad_off.data_ptr(),
            grad_mask.data_ptr(), B, H, W, Cin, Ho, Wo, stride, padding,
            _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(
                f"deform_col2im kernel launch failed: cudaError {err}")
        backward_launches += 1
    return (grad_x.to(x.dtype), grad_off.to(x.dtype), grad_mask.to(x.dtype))


def deform_col2im_plain(x, offsets, mask, grad_cols, stride=1, padding=1):
    """The same function as `deform_col2im`: autograd through
    `deform_im2col_plain`."""
    with torch.enable_grad():
        x, offsets, mask = (t.detach().requires_grad_()
                            for t in (x, offsets, mask))
        cols = deform_im2col_plain(x, offsets, mask, stride, padding)
        return torch.autograd.grad(cols, (x, offsets, mask),
                                   grad_cols.to(cols.dtype))


def deform_im2col_plain(
    x: torch.Tensor,
    offsets: torch.Tensor,
    mask: torch.Tensor,
    stride: int = 1,
    padding: int = 1,
) -> torch.Tensor:
    """The same function as `deform_im2col` in plain PyTorch: per tap,
    `F.grid_sample` (align_corners=False over pixel centres, zero padding)
    at base + tap + offset, as the JAX package's torch oracle
    (tests/test_golden_torch.py:201-243). Computes in float64, so that
    grid_sample's normalise / unnormalise round trip moves no sample, and
    returns x's dtype."""
    B, H, W, Ho, Wo = _check(x, offsets, mask, stride, padding)
    Cin = x.shape[-1]
    xt = x.permute(0, 3, 1, 2).double()
    dev = x.device
    ys = torch.arange(Ho, dtype=torch.float64, device=dev) * stride - padding
    xs = torch.arange(Wo, dtype=torch.float64, device=dev) * stride - padding
    taps = []
    for k in range(TAPS):
        ky, kx = divmod(k, KERNEL_SIZE)
        py = ys[None, :, None] + ky + offsets[..., k, 0].double()
        px = xs[None, None, :] + kx + offsets[..., k, 1].double()
        grid = torch.stack([(2.0 * px + 1.0) / W - 1.0,
                            (2.0 * py + 1.0) / H - 1.0], dim=-1)
        s = F.grid_sample(xt, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=False)  # (B, Cin, Ho, Wo)
        taps.append(s.permute(0, 2, 3, 1) * mask[..., k:k + 1].double())
    cols = torch.stack(taps, dim=3)  # (B, Ho, Wo, 9, Cin)
    return cols.reshape(B * Ho * Wo, TAPS * Cin).to(x.dtype)


def select_variant(H: int, W: int, variant: str = "shift4") -> str:
    """'int8' where the JAX op quantizes (variant 'int8' on an input grid
    whose padded size (H + 2) * (W + 2) exceeds ONEHOT_MAX_PIXELS), else
    'exact'. The JAX package's other variants are TPU gather layouts of
    the same exact function."""
    if variant == "int8" and (H + 2) * (W + 2) > ONEHOT_MAX_PIXELS:
        return "int8"
    return "exact"


def quantize_int8_plain(x: torch.Tensor):
    """The int8 table and its dequantization scales, as the JAX op: in
    float32, s = amax over (H, W) of |x| + 1e-12 per (image, channel),
    q = round-half-to-even(x * (127 / s)); the scales s / 127 cast to x's
    dtype. Returns (q (B, H, W, C) int8, scale (B, C) in x's dtype).
    Divisions are tensor by tensor, so no reciprocal replaces them."""
    xf = x.float()
    s = xf.abs().amax(dim=(1, 2)) + 1e-12
    c127 = torch.full_like(s, 127.0)
    q = torch.round(xf * (c127 / s)[:, None, None, :]).to(torch.int8)
    return q, (s / c127).to(x.dtype)


def deform_im2col_int8_plain(x, offsets, mask, stride=1, padding=1):
    """The same function as `deform_im2col_int8` in plain PyTorch: the
    dequantized table (q * scale in x's dtype) sampled by
    `deform_im2col_plain`."""
    q, scale = quantize_int8_plain(x)
    table = q.to(x.dtype) * scale[:, None, None, :]
    return deform_im2col_plain(table, offsets, mask, stride, padding)


def deform_im2col_int8(
    x: torch.Tensor,
    offsets: torch.Tensor,
    mask: torch.Tensor,
    stride: int = 1,
    padding: int = 1,
) -> torch.Tensor:
    """`deform_im2col` of x quantized to an int8 table at per-(image,
    channel) amax scales (K3), not differentiable (deform_conv2d with
    variant 'int8' carries the straight-through gradient). Same arguments
    and result layout as `deform_im2col`."""
    global int8_launches
    B, H, W, Ho, Wo = _check(x, offsets, mask, stride, padding)
    Cin = x.shape[-1]
    if x.device.type == "cpu":
        with torch.no_grad():
            return deform_im2col_int8_plain(x, offsets, mask, stride, padding)
    if x.device.type != "cuda":
        raise ValueError(f"deform_conv: unsupported device {x.device}")
    _contiguous(x=x, offsets=offsets, mask=mask)
    cols = torch.empty(B * Ho * Wo, TAPS * Cin, dtype=x.dtype, device=x.device)
    if cols.numel() == 0 or H * W == 0:  # nothing to launch
        return cols.zero_()
    amax = torch.empty(B, Cin, dtype=torch.int32, device=x.device)
    table = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(B, Cin, dtype=torch.float32, device=x.device)
    err = _lib().deform_im2col_int8(
        x.data_ptr(), offsets.data_ptr(), mask.data_ptr(), amax.data_ptr(),
        table.data_ptr(), scale.data_ptr(), cols.data_ptr(),
        B, H, W, Cin, Ho, Wo, stride, padding, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"deform_im2col_int8 kernel launch failed: cudaError {err}")
    int8_launches += 1
    return cols


class _DeformConvInt8(torch.autograd.Function):
    """cols_int8 @ w forward; the fp conv's exact gradient backward (the
    straight-through estimator of the JAX op's `_int8_bwd`)."""

    @staticmethod
    def forward(ctx, x, offsets, mask, w, stride, padding):
        ctx.save_for_backward(x, offsets, mask, w)
        ctx.conv = (stride, padding)
        cols = deform_im2col_int8(x, offsets, mask, stride, padding)
        return torch.matmul(cols, w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        x, offsets, mask, w = ctx.saved_tensors
        grad_out = grad_out.to(x.dtype)
        grads = deform_col2im(x, offsets, mask, grad_out @ w.t(), *ctx.conv)
        grad_w = None
        if ctx.needs_input_grad[3]:
            cols = deform_im2col(x, offsets, mask, *ctx.conv)  # fp tile
            grad_w = cols.t() @ grad_out
        return (*grads, grad_w, None, None)


def deform_conv2d(
    x: torch.Tensor,
    offsets: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    stride: int = 1,
    padding: int = 1,
    variant: str = "shift4",
) -> torch.Tensor:
    """Modulated deformable 3x3 conv, channels-last.

    Args:
      x: (B, H, W, Cin); offsets (B, Ho, Wo, 9, 2) as (dy, dx); mask
        (B, Ho, Wo, 9), all in one dtype.
      weight: (Cout, Cin, 3, 3), the reference's (mmcv) layout; cast to
        x's dtype.
      variant: BackboneConfig.dcn_gather. 'int8' samples a quantized
        table where `select_variant` says so; every other value is exact.

    Returns (B, Ho, Wo, Cout) in x's dtype.
    """
    B, H, W = x.shape[:3]
    Cout, Cin = weight.shape[:2]
    w = weight.to(x.dtype).permute(2, 3, 1, 0).reshape(TAPS * Cin, Cout)
    Ho, Wo = offsets.shape[1:3]
    if select_variant(H, W, variant) == "int8":
        out = _DeformConvInt8.apply(x, offsets, mask, w, stride, padding)
    else:
        out = torch.matmul(deform_im2col(x, offsets, mask, stride, padding), w)
    return out.view(B, Ho, Wo, Cout)
