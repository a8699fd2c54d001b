"""K2's fused route, plain versions (CPU, fp32), against the JAX op.

`graph_detr4d_tpu_torch.ops.deform_conv.deform_conv2d_backward_plain` (the
function the fused backward kernel is held to on the card) against
`jax.vjp` of `graph_detr4d_tpu.ops.deform_conv.deform_conv2d`, on the same
seeded numpy inputs: both strides, input grids below and above the JAX
op's one-hot threshold, taps outside the image. Tolerance: 1e-4 of each
gradient's magnitude where that exceeds 1, as tests/test_torch_train_ops.py
(the offset gradients carry the sampling position's fp32 rounding on the
JAX side, which the float64 plain version does not have). The CPU entry
points of the route (`deform_conv`, `deform_conv_forward`,
`deform_conv_backward`) are the plain versions.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_ops import DCN_SIZES  # noqa: E402
from tests.test_torch_train_ops import assert_grad_close  # noqa: E402

from graph_detr4d_tpu.ops import deform_conv as jax_dcn  # noqa: E402
from graph_detr4d_tpu_torch.ops import deform_conv as dcn_ops  # noqa: E402


def _case(seed, H, W, stride, B=2, Cin=8, Cout=6):
    rng = np.random.RandomState(seed)
    Ho = dcn_ops.output_size(H, stride, 1)
    Wo = dcn_ops.output_size(W, stride, 1)
    x = rng.randn(B, H, W, Cin).astype(np.float32)
    off = (rng.randn(B, Ho, Wo, 9, 2) * 2.5).astype(np.float32)
    mask = rng.rand(B, Ho, Wo, 9).astype(np.float32)
    w = (rng.randn(9, Cin, Cout) / np.sqrt(9 * Cin)).astype(np.float32)
    g = rng.randn(B, Ho, Wo, Cout).astype(np.float32)
    return x, off, mask, w, g


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("branch", sorted(DCN_SIZES))
def test_backward_plain_matches_jax_vjp(branch, stride):
    H, W = DCN_SIZES[branch]
    x, off, mask, w, g = _case(11, H, W, stride)
    Cin, Cout = w.shape[1:]
    out, vjp = jax.vjp(
        lambda *a: jax_dcn.deform_conv2d(*a, stride=stride, padding=1),
        *(jnp.asarray(a) for a in (x, off, mask, w)))
    want = vjp(jnp.asarray(g))
    t = [torch.from_numpy(a) for a in (x, off, mask, w.reshape(9 * Cin, Cout))]
    got = dcn_ops.deform_conv2d_backward_plain(*t, torch.from_numpy(g), stride)
    for name, a, b in zip(("x", "offsets", "mask"), got, want):
        assert_grad_close(a, b, name)
    assert_grad_close(got[3].reshape(9, Cin, Cout), want[3], "weight")
    fwd = dcn_ops.deform_conv2d_plain(*t, stride)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(out), rtol=0, atol=1e-4)


@pytest.mark.parametrize("stride", [1, 2])
def test_cpu_route_is_the_plain_version(stride):
    """deform_conv_forward / deform_conv_backward on CPU tensors are the
    plain versions, at a ragged size (Cin 5, Cout 3, 7 x 9 pixels); the
    differentiable deform_conv gives the same gradients through autograd,
    and weight_grad=False leaves the weight's out."""
    x, off, mask, w, g = _case(12, 7, 9, stride, B=1, Cin=5, Cout=3)
    t = [torch.from_numpy(a) for a in (x, off, mask, w.reshape(45, 3))]
    g = torch.from_numpy(g)
    want = dcn_ops.deform_conv2d_backward_plain(*t, g, stride)
    torch.testing.assert_close(dcn_ops.deform_conv_forward(*t, stride),
                               dcn_ops.deform_conv2d_plain(*t, stride),
                               rtol=0, atol=0)
    got = dcn_ops.deform_conv_backward(*t, g, stride)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert dcn_ops.deform_conv_backward(*t, g, stride,
                                        weight_grad=False)[3] is None
    leaves = [a.clone().requires_grad_() for a in t]
    (dcn_ops.deform_conv(*leaves, stride) * g).sum().backward()
    for a, b in zip(leaves, want):
        torch.testing.assert_close(a.grad, b, rtol=1e-6, atol=1e-6)


def test_backward_validates_grad_out():
    x, off, mask, w, g = _case(13, 6, 6, 1, B=1, Cin=4, Cout=2)
    t = [torch.from_numpy(a) for a in (x, off, mask, w.reshape(36, 2))]
    with pytest.raises(ValueError):
        dcn_ops.deform_conv_backward(*t, torch.from_numpy(g)[..., :1])
    with pytest.raises(TypeError):
        dcn_ops.deform_conv_forward(*t[:3], t[3].double())
