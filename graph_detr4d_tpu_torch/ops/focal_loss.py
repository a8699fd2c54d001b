"""K5: sigmoid focal loss over all decoder layers, with its gradient.

Counterpart of graph_detr4d_tpu/ops/focal_loss.py::sigmoid_focal_loss as
graph_detr4d_tpu/core/losses.py vmaps it over the decoder layers: the
stable BCE-with-logits form, label `num_classes` = background (all-zero
target), per-sample weights, the sum divided by a per-layer avg_factor.

`sigmoid_focal_loss` is differentiable in the logits. For a CUDA tensor it
launches `csrc/focal_loss.cu`, which gives every layer's summed loss and
d loss / d logits in one pass (one launch for all layers, blocks of 64
query rows that sum across blocks through a small scratch kept per device
and stream), inside an autograd Function whose backward scales the saved
gradient by grad_out.
For a CPU tensor it runs `sigmoid_focal_loss_plain`, the JAX formula,
which autograd differentiates.
"""

import ctypes
import functools

import torch

from . import build

# kernel launches made by sigmoid_focal_loss (plain int; chip_smoke.py
# resets it before driving the main path and reads it after)
launches = 0


@functools.cache
def _lib():
    lib = build.load("focal_loss")
    lib.focal_loss.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.focal_loss.restype = ctypes.c_int
    lib.focal_loss_scratch_bytes.argtypes = [ctypes.c_int] * 2
    lib.focal_loss_scratch_bytes.restype = ctypes.c_int64
    return lib


# the kernel's scratch per (device, stream): its cross-block ticket, which
# every call leaves at 0, and the per-block partial sums. Zeroed once when
# made or grown, never per call; a stream's calls run in order, so they
# can share it.
_scratch = {}


@functools.lru_cache(maxsize=64)
def _scratch_bytes(layers, N):
    return _lib().focal_loss_scratch_bytes(layers, N)


def _scratch_ptr(device, stream, nbytes):
    key = (device, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = _scratch[key] = torch.zeros(max(nbytes, 4096), dtype=torch.uint8,
                                          device=device)
    return buf.data_ptr()


def _check(logits, labels, weights, avg_factor):
    if logits.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("focal_loss: logits and weights must be float32")
    if logits.dim() != 3:
        raise ValueError(
            f"focal_loss: logits must be (layers, N, C), got {tuple(logits.shape)}")
    layers, N, _ = logits.shape
    if tuple(labels.shape) != (layers, N) or tuple(weights.shape) != (layers, N):
        raise ValueError(
            f"focal_loss: labels {tuple(labels.shape)} / weights "
            f"{tuple(weights.shape)} != {(layers, N)}")
    if tuple(avg_factor.shape) != (layers,):
        raise ValueError(
            f"focal_loss: avg_factor {tuple(avg_factor.shape)} != {(layers,)}")
    if labels.dtype != torch.int64:
        raise TypeError("focal_loss: labels must be int64")
    if any(t.device != logits.device for t in (labels, weights, avg_factor)):
        raise ValueError("focal_loss: all tensors must be on one device")


def sigmoid_focal_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    weights: torch.Tensor,
    avg_factor: torch.Tensor,
    alpha: float = 0.25,
    gamma: float = 2.0,
) -> torch.Tensor:
    """Per-layer focal loss.

    Args:
      logits: (layers, N, C) float32.
      labels: (layers, N) int64 in [0, C]; C means background.
      weights: (layers, N) float32 per-sample weights.
      avg_factor: (layers,) float32; each layer's sum is divided by it (no
        clamping here: the caller applies the reference's max(., 1)).

    Returns (layers,) float32 losses.
    """
    _check(logits, labels, weights, avg_factor)
    if logits.device.type == "cpu":
        return sigmoid_focal_loss_plain(logits, labels, weights, avg_factor,
                                        alpha, gamma)
    if logits.device.type != "cuda":
        raise ValueError(f"focal_loss: unsupported device {logits.device}")
    return _FocalLoss.apply(logits, labels, weights, avg_factor, alpha, gamma)


class _FocalLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, weights, avg_factor, alpha, gamma):
        loss, grad = focal_loss_with_grad(logits, labels, weights, avg_factor,
                                          alpha, gamma)
        ctx.save_for_backward(grad)
        return loss

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_loss):
        (grad,) = ctx.saved_tensors
        return grad * grad_loss[:, None, None], None, None, None, None, None


def focal_loss_with_grad(logits, labels, weights, avg_factor, alpha=0.25,
                         gamma=2.0):
    """(losses (layers,), d losses / d logits (layers, N, C)) from one
    kernel launch; CUDA tensors only."""
    global launches
    _check(logits, labels, weights, avg_factor)
    if logits.device.type != "cuda":
        raise ValueError(f"focal_loss: the kernel needs CUDA, got {logits.device}")
    logits, labels, weights, avg_factor = (
        t.contiguous() for t in (logits, labels, weights, avg_factor))
    layers, N, C = logits.shape
    device = logits.device
    # the kernel writes every element of both
    loss = torch.empty(layers, dtype=torch.float32, device=device)
    grad = torch.empty_like(logits)
    if layers == 0 or C == 0:  # nothing to launch
        return loss.zero_(), grad
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _lib().focal_loss(
        logits.data_ptr(), labels.data_ptr(), weights.data_ptr(),
        avg_factor.data_ptr(), loss.data_ptr(), grad.data_ptr(),
        _scratch_ptr(device, stream, _scratch_bytes(layers, N)),
        layers, N, C, alpha, gamma, stream,
    )
    if err != 0:
        raise RuntimeError(f"focal_loss kernel launch failed: cudaError {err}")
    launches += 1
    return loss, grad


def sigmoid_focal_loss_plain(logits, labels, weights, avg_factor, alpha=0.25,
                             gamma=2.0):
    """The same function as `sigmoid_focal_loss`, the JAX formula in plain
    PyTorch (differentiable by autograd)."""
    C = logits.shape[-1]
    target = (labels[..., None] == torch.arange(C, device=logits.device)).to(
        logits.dtype)
    p = torch.sigmoid(logits)
    bce = (logits.clamp(min=0) - logits * target
           + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * target + (1.0 - p) * (1.0 - target)
    alpha_t = alpha * target + (1.0 - alpha) * (1.0 - target)
    loss = alpha_t * (1.0 - p_t) ** gamma * bce * weights[..., None]
    return loss.sum(dim=(1, 2)) / avg_factor
