"""K3, the int8 DCN table, against the JAX package's `variant="int8"`
(plain versions, CPU, fp32).

The JAX op quantizes only where the DCN input's padded grid has more than
ONEHOT_MAX_PIXELS = 1536 pixels; smaller grids take its exact one-hot path
whatever the variant. So every int8 case here is at least 40x48 (2100
padded pixels): at 8x8 both sides would silently compare the exact path.
Tolerances: 1e-5 on the conv output (both sides gather the same int8
table and dequantize with the same scales; they sum in another order),
1e-4 on the straight-through gradients (the fp conv's exact vjp).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from graph_detr4d_tpu.ops import deform_conv as jax_dcn  # noqa: E402
from graph_detr4d_tpu.models import resnet as jax_resnet  # noqa: E402
from graph_detr4d_tpu_torch import weights  # noqa: E402
from graph_detr4d_tpu_torch.models import resnet  # noqa: E402
from graph_detr4d_tpu_torch.ops import deform_conv as dcn_ops  # noqa: E402
from tests.test_torch_modules import (  # noqa: E402
    jax_vars, load, nchw, perturb_variables)

ATOL = 1e-5
GRAD_ATOL = 1e-4


def _case(seed, H=40, W=48, stride=1, B=2, Cin=8, Cout=6, ties=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, Cin).astype(np.float32)
    if ties:
        # channel amax exactly 127/128, so x * (127 / s) = 128 x: every
        # value is a half-integer over 128 and lands on a rounding tie
        # (half-to-even decides it)
        x = ((rng.randint(-126, 126, size=x.shape) + 0.5) / 128).astype(
            np.float32)
        x[:, 0, 0, :] = 127.0 / 128
    Ho = (H + 2 - 3) // stride + 1
    Wo = (W + 2 - 3) // stride + 1
    off = (rng.randn(B, Ho, Wo, 9, 2) * 2.0).astype(np.float32)
    mask = (1.0 / (1.0 + np.exp(-rng.randn(B, Ho, Wo, 9)))).astype(np.float32)
    w = (rng.randn(9, Cin, Cout) / np.sqrt(9 * Cin)).astype(np.float32)
    return x, off, mask, w


def _torch_weight(w):
    """JAX (9, Cin, Cout) tap-major -> mmcv (Cout, Cin, 3, 3)."""
    _, cin, cout = w.shape
    return torch.from_numpy(
        np.ascontiguousarray(np.transpose(w.reshape(3, 3, cin, cout), (3, 2, 0, 1))))


def test_variant_selection_follows_the_jax_threshold():
    assert dcn_ops.ONEHOT_MAX_PIXELS == jax_dcn.ONEHOT_MAX_PIXELS
    assert dcn_ops.select_variant(40, 48, "int8") == "int8"
    assert dcn_ops.select_variant(40, 48, "shift4") == "exact"
    # flagship stage 4 (20x50: 22*52 = 1144 padded pixels) stays exact
    assert dcn_ops.select_variant(20, 50, "int8") == "exact"
    assert dcn_ops.select_variant(80, 200, "int8") == "int8"
    # the boundary: 1536 padded pixels is still exact
    assert dcn_ops.select_variant(30, 46, "int8") == "exact"  # 32*48
    assert dcn_ops.select_variant(31, 46, "int8") == "int8"  # 33*48


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("ties", [False, True])
def test_int8_deform_conv_matches_jax(stride, ties):
    x, off, mask, w = _case(stride + 2 * ties, stride=stride, ties=ties)
    assert (x.shape[1] + 2) * (x.shape[2] + 2) > jax_dcn.ONEHOT_MAX_PIXELS
    want = np.asarray(jax_dcn.deform_conv2d(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask), jnp.asarray(w),
        stride=stride, variant="int8"))
    got = dcn_ops.deform_conv2d(
        torch.from_numpy(x), torch.from_numpy(off), torch.from_numpy(mask),
        _torch_weight(w), stride=stride, variant="int8")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # and it is the quantized function, not the exact one
    exact = np.asarray(jax_dcn.deform_conv2d(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask), jnp.asarray(w),
        stride=stride, variant="shift4"))
    assert np.abs(exact - want).max() > 100 * ATOL


def test_int8_quantization_matches_the_jax_table():
    """The table and scales themselves, on rounding ties: q = round half
    to even of x * (127 / s), the scales s / 127."""
    x, *_ = _case(5, ties=True)
    xf = jnp.asarray(x)
    s = jnp.max(jnp.abs(xf), axis=(1, 2)) + 1e-12
    want_q = np.asarray(jnp.round(xf * (127.0 / s)[:, None, None, :]).astype(
        jnp.int8))
    q, scale = dcn_ops.quantize_int8_plain(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), want_q)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(s / 127.0))
    # ties went to even: 2.5 -> 2, 3.5 -> 4
    flat, qf = x.reshape(-1) * 128, q.numpy().reshape(-1)
    assert set(qf[flat == 2.5]) == {2} and set(qf[flat == 3.5]) == {4}


@pytest.mark.parametrize("stride", [1, 2])
def test_int8_straight_through_gradient_matches_jax(stride):
    x, off, mask, w = _case(10 + stride, stride=stride)
    r = np.random.RandomState(20 + stride).randn(
        x.shape[0], off.shape[1], off.shape[2], w.shape[-1]).astype(np.float32)

    def loss(a, b, c, d):
        out = jax_dcn.deform_conv2d(a, b, c, d, stride=stride, variant="int8")
        return jnp.sum(out * jnp.asarray(r))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask), jnp.asarray(w))
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, off, mask)]
    wt = _torch_weight(w).requires_grad_()
    out = dcn_ops.deform_conv2d(*leaves, wt, stride=stride, variant="int8")
    (out * torch.from_numpy(r)).sum().backward()
    for name, got, ref in zip(("x", "offsets", "mask"), leaves, want[:3]):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), rtol=0,
                                   atol=GRAD_ATOL, err_msg=name)
    gw = wt.grad.permute(2, 3, 1, 0).reshape(w.shape).numpy()
    np.testing.assert_allclose(gw, np.asarray(want[3]), rtol=0, atol=GRAD_ATOL)


def test_resnet50_int8_takes_the_int8_table_on_one_conv_only():
    """ResNet-50 + DCN, dcn_gather='int8', one 256x384 image: stage 3's
    first DCN (input 32x48, 1700 padded pixels) quantizes, the other eight
    DCNs (16x24 and 8x12 inputs) stay exact, as in the JAX model.

    fp32 rounding differences between two conv stacks (up to 1.9e-5 at
    that conv's input) move a few of its input values across a rounding
    tie of the table (measured: 9 of 393,216), each moving its table entry
    by a whole quantization step and the stage-3 output by up to 8.7e-3.
    So that conv gets JAX's own input (its bn1 output after relu, captured
    from the JAX model), and everything downstream is held to the exact
    path's tolerance, 1e-4."""
    x = np.random.RandomState(0).randn(1, 256, 384, 3).astype(np.float32)
    model = jax_resnet.ResNet(depth=50, use_dcn=True, dcn_gather="int8")
    v = perturb_variables(
        jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    want, state = jax.jit(lambda v, x: model.apply(
        v, x, capture_intermediates=True, mutable=["intermediates"]))(
            jax_vars(v), jnp.asarray(x))
    bn1 = state["intermediates"]["layer3_block0"]["bn1"]["__call__"][0]
    dcn_in = nchw(np.maximum(np.asarray(bn1), 0.0))

    port = load(resnet.ResNet(depth=50, use_dcn=True, dcn_gather="int8"),
                weights.backbone_state_dict(v["params"], v["batch_stats"]))
    chosen = {}

    def record(name):
        def hook(mod, args):
            H, W = args[0].shape[2:]
            chosen[name] = dcn_ops.select_variant(H, W, mod.gather)
        return hook

    for name, mod in port.named_modules():
        if isinstance(mod, resnet.DeformConv):
            mod.register_forward_pre_hook(record(name))
    port.layer3[0].conv2.register_forward_pre_hook(lambda mod, args: (dcn_in,))
    with torch.no_grad():
        got = port(nchw(x))
    assert chosen == {
        "layer3.0.conv2": "int8",
        **{f"layer3.{b}.conv2": "exact" for b in range(1, 6)},
        **{f"layer4.{b}.conv2": "exact" for b in range(3)},
    }
    for stage, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(
            g.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=1e-4,
            atol=1e-4, err_msg=f"stage {stage}")
