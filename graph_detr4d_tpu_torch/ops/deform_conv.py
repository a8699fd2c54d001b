"""K2: modulated deformable convolution (DCNv2), forward and backward.

Counterpart of graph_detr4d_tpu/ops/deform_conv.py::deform_conv2d, with
mmcv's ModulatedDeformConv2d semantics: per output pixel and 3x3 tap, a
learned (dy, dx) offset shifts the tap's sampling point, the input is
sampled bilinearly with zero padding, scaled by the modulation mask, and
contracted with the conv weight.

`deform_conv` is the differentiable conv on the tap-major (9*Cin, Cout)
weight. For a CUDA tensor it runs the two fused kernels of
`csrc/deform_conv.cu` inside an autograd Function that saves only x,
offsets, mask and the weight: `deform_conv_forward` (one kernel launch per
call: sampling and contraction, the column tile never written) and
`deform_conv_backward` (the x / offsets / mask gradients in one kernel;
the weight gradient in up to three more: a corner table, the gradient by
pixel slices, and the slices' sum when there is more than one). For a CPU
tensor it is `deform_conv2d_plain` (per-tap
`F.grid_sample`, then a matrix product), which autograd differentiates;
`deform_conv2d_backward_plain` is that gradient.

K3, the int8 variant (`variant="int8"`, counterpart of
graph_detr4d_tpu/ops/deform_conv.py::_deform_conv_int8): the input is
quantized to an int8 table at per-(image, channel) amax scales, and the
taps are gathered from it, dequantized and contracted with the weight
(`deform_conv_int8_forward`: for a CUDA tensor the `csrc/deform_conv_int8.cu`
kernels, amax, quantize and K2's fused forward over the table, no column
tile written; for a CPU one `deform_conv2d_int8_plain`). Its gradient is
straight-through, the exact gradient of the fp conv
(`deform_conv_backward`), as the JAX op's `_int8_bwd`. Like the JAX
op, it applies only where the input's padded grid has more than
ONEHOT_MAX_PIXELS pixels; smaller grids stay exact (`select_variant`).
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build

# calls that launched kernels: deform_conv_forward (1 launch each),
# deform_conv_backward (2-4 each, 1 without the weight gradient) and
# deform_conv_int8_forward (3 each); plain ints, chip_smoke.py resets them
# before driving the main path and reads them after
forward_launches = 0
backward_launches = 0
int8_launches = 0

KERNEL_SIZE = 3
TAPS = KERNEL_SIZE * KERNEL_SIZE
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# at or below this padded-grid pixel count the JAX op samples exactly,
# whatever the variant (graph_detr4d_tpu/ops/deform_conv.py:27, 111)
ONEHOT_MAX_PIXELS = 1536
# K3's kernel reads the int8 table 16 channels at a time
INT8_CHANNEL_MULTIPLE = 16


@functools.cache
def _lib():
    return _bind(build.load("deform_conv"))


def _bind(lib):
    """Set the C signatures of csrc/deform_conv.cu's entry points."""
    lib.deform_conv_forward.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 10 + [ctypes.c_void_p]
    lib.deform_conv_forward.restype = ctypes.c_int
    lib.deform_conv_backward_workspace.argtypes = [ctypes.c_int] * 6
    lib.deform_conv_backward_workspace.restype = ctypes.c_longlong
    lib.deform_conv_backward.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_longlong] + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    lib.deform_conv_backward.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_int8():
    lib = build.load("deform_conv_int8")
    lib.deform_conv_int8_forward.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int] * 10 + [ctypes.c_void_p]
    lib.deform_conv_int8_forward.restype = ctypes.c_int
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


def _check_weight(x, w):
    """w: the tap-major (9*Cin, Cout) weight, in x's dtype, on x's device.
    Returns Cout."""
    if w.dim() != 2 or w.shape[0] != TAPS * x.shape[-1]:
        raise ValueError(f"deform_conv: weight {tuple(w.shape)} is not "
                         f"(9 * {x.shape[-1]}, Cout)")
    if w.dtype != x.dtype:
        raise TypeError(f"deform_conv: weight dtype {w.dtype} != {x.dtype}")
    if w.device != x.device:
        raise ValueError("deform_conv: all tensors must be on one device")
    return w.shape[1]


def _contiguous(**tensors):
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"deform_conv: {name} must be contiguous")


def _on_cuda(x):
    if x.device.type != "cuda":
        raise ValueError(f"deform_conv: unsupported device {x.device}")


def deform_conv(
    x: torch.Tensor,
    offsets: torch.Tensor,
    mask: torch.Tensor,
    w: torch.Tensor,
    stride: int = 1,
    padding: int = 1,
) -> torch.Tensor:
    """The exact modulated deformable 3x3 conv on the tap-major weight,
    differentiable in x, offsets, mask and w.

    Args:
      x: (B, H, W, Cin) float32 or bfloat16, channels-last.
      offsets: (B, Ho, Wo, 9, 2) per-tap (dy, dx), x's dtype.
      mask: (B, Ho, Wo, 9) modulation (already sigmoid-ed), x's dtype.
      w: (9*Cin, Cout) in x's dtype; row k*Cin + c is input channel c at
        tap k = ky*3 + kx.

    Returns (B, Ho, Wo, Cout) in x's dtype.
    """
    if x.device.type == "cpu":
        return deform_conv2d_plain(x, offsets, mask, w, stride, padding)
    _on_cuda(x)
    return _DeformConv.apply(x, offsets, mask, w, stride, padding)


class _DeformConv(torch.autograd.Function):
    """The fused kernels; saves x, offsets, mask and w, no column tile."""

    @staticmethod
    def forward(ctx, x, offsets, mask, w, stride, padding):
        ctx.save_for_backward(x, offsets, mask, w)
        ctx.conv = (stride, padding)
        return deform_conv_forward(x, offsets, mask, w, stride, padding)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        x, offsets, mask, w = ctx.saved_tensors
        grads = deform_conv_backward(x, offsets, mask, w, grad_out, *ctx.conv,
                                     weight_grad=ctx.needs_input_grad[3])
        return (*grads, None, None)


def deform_conv_forward(
    x: torch.Tensor,
    offsets: torch.Tensor,
    mask: torch.Tensor,
    w: torch.Tensor,
    stride: int = 1,
    padding: int = 1,
) -> torch.Tensor:
    """`deform_conv` without autograd: the fused forward kernel for CUDA
    tensors, `deform_conv2d_plain` for CPU tensors."""
    global forward_launches
    B, H, W, Ho, Wo = _check(x, offsets, mask, stride, padding)
    Cin, Cout = x.shape[-1], _check_weight(x, w)
    if x.device.type == "cpu":
        return deform_conv2d_plain(x, offsets, mask, w, stride, padding)
    _on_cuda(x)
    _contiguous(x=x, offsets=offsets, mask=mask, weight=w)
    if Cin == 0:  # an empty sum
        return torch.zeros(B, Ho, Wo, Cout, dtype=x.dtype, device=x.device)
    out = torch.empty(B, Ho, Wo, Cout, dtype=x.dtype, device=x.device)
    if out.numel() == 0:  # nothing to launch
        return out
    wt = w.t().contiguous()  # the kernel reads the weight K-major
    err = _lib().deform_conv_forward(
        x.data_ptr(), offsets.data_ptr(), mask.data_ptr(), wt.data_ptr(),
        out.data_ptr(), B, H, W, Cin, Ho, Wo, Cout, stride, padding,
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"deform_conv_forward kernel launch failed: cudaError {err}")
    forward_launches += 1
    return out


def deform_conv_backward(
    x: torch.Tensor,
    offsets: torch.Tensor,
    mask: torch.Tensor,
    w: torch.Tensor,
    grad_out: torch.Tensor,
    stride: int = 1,
    padding: int = 1,
    weight_grad: bool = True,
):
    """Gradients of `deform_conv` for (x, offsets, mask, w) given grad_out
    (B, Ho, Wo, Cout), each in its input's dtype (None for w without
    weight_grad). The fused backward kernels for CUDA tensors (fp32 sums,
    cast at the end), `deform_conv2d_backward_plain` for CPU tensors. The
    data-gradient kernel keeps its pixels' grad_out rows in shared memory,
    so Cout is bounded by the card's shared memory (on an H100: 1,408 in
    bf16, 640 in fp32); beyond it the launch is refused and this raises."""
    global backward_launches
    B, H, W, Ho, Wo = _check(x, offsets, mask, stride, padding)
    Cin, Cout = x.shape[-1], _check_weight(x, w)
    if tuple(grad_out.shape) != (B, Ho, Wo, Cout):
        raise ValueError(f"deform_conv: grad_out {tuple(grad_out.shape)} != "
                         f"{(B, Ho, Wo, Cout)}")
    if x.device.type == "cpu":
        grads = deform_conv2d_backward_plain(x, offsets, mask, w, grad_out,
                                             stride, padding)
        return (*grads[:3], grads[3] if weight_grad else None)
    _on_cuda(x)
    grad_out = grad_out.to(x.dtype).contiguous()
    _contiguous(x=x, offsets=offsets, mask=mask, weight=w)
    f32 = dict(dtype=torch.float32, device=x.device)
    if B * Ho * Wo == 0 or Cin == 0 or Cout == 0:  # nothing to launch
        grads = [torch.zeros(t.shape, **f32) for t in (x, offsets, mask, w)]
    else:
        grads = [torch.empty(t.shape, **f32) for t in (x, offsets, mask, w)]
        lib = _lib()
        dtype = _DTYPES[x.dtype]
        ws_bytes = lib.deform_conv_backward_workspace(
            B, Ho, Wo, Cin, Cout, dtype) if weight_grad else 0
        workspace = torch.empty(max(ws_bytes, 1), dtype=torch.uint8,
                                device=x.device)
        err = lib.deform_conv_backward(
            x.data_ptr(), offsets.data_ptr(), mask.data_ptr(), w.data_ptr(),
            grad_out.data_ptr(), *(g.data_ptr() for g in grads[:3]),
            grads[3].data_ptr() if weight_grad else None,
            workspace.data_ptr(), ws_bytes, B, H, W, Cin, Ho, Wo, Cout,
            stride, padding, dtype,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(
                f"deform_conv_backward kernel launch failed: cudaError {err}"
                f" (Cout {Cout} beyond the resident grad_out tile?)")
        backward_launches += 1
    return (grads[0].to(x.dtype), grads[1].to(x.dtype), grads[2].to(x.dtype),
            grads[3].to(w.dtype) if weight_grad else None)


def deform_conv2d_plain(x, offsets, mask, w, stride=1, padding=1):
    """The same function as `deform_conv_forward` in plain PyTorch:
    `deform_im2col_plain(...) @ w`, reshaped to (B, Ho, Wo, Cout)."""
    B, _, _, Ho, Wo = _check(x, offsets, mask, stride, padding)
    Cout = _check_weight(x, w)
    cols = deform_im2col_plain(x, offsets, mask, stride, padding)
    return torch.matmul(cols, w).view(B, Ho, Wo, Cout)


def deform_conv2d_backward_plain(x, offsets, mask, w, grad_out, stride=1,
                                 padding=1):
    """The same function as `deform_conv_backward`: autograd through
    `deform_conv2d_plain`. Returns the gradients for (x, offsets, mask, w)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, offsets, mask, w)]
        out = deform_conv2d_plain(*leaves, stride, padding)
        return torch.autograd.grad(out, leaves, grad_out.to(out.dtype))


def deform_im2col_plain(
    x: torch.Tensor,
    offsets: torch.Tensor,
    mask: torch.Tensor,
    stride: int = 1,
    padding: int = 1,
) -> torch.Tensor:
    """Sampled, mask-scaled 3x3 columns of a modulated deformable conv, in
    plain PyTorch: per tap, `F.grid_sample` (align_corners=False over pixel
    centres, zero padding) at base + tap + offset, as the JAX package's
    torch oracle (tests/test_golden_torch.py:201-243). Computes in float64,
    so that grid_sample's normalise / unnormalise round trip moves no
    sample, and returns x's dtype.

    Args:
      x: (B, H, W, Cin) float32 or bfloat16, channels-last.
      offsets: (B, Ho, Wo, 9, 2) per-tap (dy, dx), x's dtype.
      mask: (B, Ho, Wo, 9) modulation (already sigmoid-ed), x's dtype.

    Returns (B*Ho*Wo, 9*Cin) in x's dtype, tap-major: column k*Cin + c is
    channel c sampled at tap k = ky*3 + kx.
    """
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
    """The int8 variant's column tile in plain PyTorch: the dequantized
    table (q * scale in x's dtype) sampled by `deform_im2col_plain`."""
    q, scale = quantize_int8_plain(x)
    table = q.to(x.dtype) * scale[:, None, None, :]
    return deform_im2col_plain(table, offsets, mask, stride, padding)


def deform_conv2d_int8_plain(x, offsets, mask, w, stride=1, padding=1):
    """The same function as `deform_conv_int8_forward` in plain PyTorch:
    quantize, the plain column tile, `torch.matmul` with the tap-major
    (9*Cin, Cout) weight. Returns (B, Ho, Wo, Cout) in x's dtype."""
    B, _, _, Ho, Wo = _check(x, offsets, mask, stride, padding)
    Cout = _check_weight(x, w)
    cols = deform_im2col_int8_plain(x, offsets, mask, stride, padding)
    return torch.matmul(cols, w).view(B, Ho, Wo, Cout)


def deform_conv_int8_forward(
    x: torch.Tensor,
    offsets: torch.Tensor,
    mask: torch.Tensor,
    w: torch.Tensor,
    stride: int = 1,
    padding: int = 1,
) -> torch.Tensor:
    """K3 without autograd: the conv of x quantized to an int8 table at
    per-(image, channel) amax scales, on the tap-major (9*Cin, Cout)
    weight. Same arguments and result as `deform_conv_forward`. For CUDA
    tensors the fused kernels of `csrc/deform_conv_int8.cu` (amax,
    quantize, then one implicit GEMM over the table; Cin must be a
    multiple of 16), for CPU tensors `deform_conv2d_int8_plain`."""
    global int8_launches
    B, H, W, Ho, Wo = _check(x, offsets, mask, stride, padding)
    Cin, Cout = x.shape[-1], _check_weight(x, w)
    if x.device.type == "cpu":
        return deform_conv2d_int8_plain(x, offsets, mask, w, stride, padding)
    _on_cuda(x)
    _contiguous(x=x, offsets=offsets, mask=mask, weight=w)
    if Cin % INT8_CHANNEL_MULTIPLE:
        raise ValueError(f"deform_conv_int8: Cin {Cin} is not a multiple of "
                         f"{INT8_CHANNEL_MULTIPLE} (the kernel's 16-byte "
                         "table loads)")
    out = torch.empty(B, Ho, Wo, Cout, dtype=x.dtype, device=x.device)
    if out.numel() == 0 or Cin == 0 or H * W == 0:  # nothing to launch
        return out.zero_()
    wt = w.t().contiguous()  # the kernel reads the weight K-major
    amax = torch.empty(B, Cin, dtype=torch.int32, device=x.device)
    table = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(B, Cin, dtype=torch.float32, device=x.device)
    err = _lib_int8().deform_conv_int8_forward(
        x.data_ptr(), offsets.data_ptr(), mask.data_ptr(), wt.data_ptr(),
        amax.data_ptr(), table.data_ptr(), scale.data_ptr(), out.data_ptr(),
        B, H, W, Cin, Ho, Wo, Cout, stride, padding, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"deform_conv_int8_forward kernel launch failed: cudaError {err}")
    int8_launches += 1
    return out


class _DeformConvInt8(torch.autograd.Function):
    """K3 forward; the fp conv's exact gradient backward (the
    straight-through estimator of the JAX op's `_int8_bwd`)."""

    @staticmethod
    def forward(ctx, x, offsets, mask, w, stride, padding):
        ctx.save_for_backward(x, offsets, mask, w)
        ctx.conv = (stride, padding)
        return deform_conv_int8_forward(x, offsets, mask, w, stride, padding)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        x, offsets, mask, w = ctx.saved_tensors
        grads = deform_conv_backward(x, offsets, mask, w, grad_out, *ctx.conv,
                                     weight_grad=ctx.needs_input_grad[3])
        return (*grads, None, None)


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
    H, W = x.shape[1:3]
    Cout, Cin = weight.shape[:2]
    w = weight.to(x.dtype).permute(2, 3, 1, 0).reshape(TAPS * Cin, Cout)
    if select_variant(H, W, variant) == "int8":
        return _DeformConvInt8.apply(x, offsets, mask, w, stride, padding)
    return deform_conv(x, offsets, mask, w, stride, padding)
