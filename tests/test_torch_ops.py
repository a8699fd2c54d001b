"""The port's kernel ops (plain versions, CPU) against the JAX ops.

K1 `graph_detr4d_tpu_torch.ops.msda.msda_forward` vs
`graph_detr4d_tpu.ops.msda.multi_scale_deformable_attention`, and K2
`graph_detr4d_tpu_torch.ops.deform_conv.deform_conv2d` vs
`graph_detr4d_tpu.ops.deform_conv.deform_conv2d`, on the same seeded numpy
inputs. Both of each JAX op's branches are covered: levels above and below
its one-hot threshold (ONEHOT_MAX_PIXELS), both strides, and samples
outside the image. Tolerance: atol 1e-4 in fp32, the JAX goldens' own
(tests/test_golden_torch.py:144-149); the two sides sum the same terms in
another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from graph_detr4d_tpu.ops import deform_conv as jax_dcn
from graph_detr4d_tpu.ops import msda as jax_msda
from graph_detr4d_tpu_torch.ops import deform_conv as dcn_ops
from graph_detr4d_tpu_torch.ops import msda as msda_ops

ATOL = 1e-4

# level sets: every level one-hot in JAX, or the first on its gather path
MSDA_LEVELS = {
    "onehot": [(10, 18), (5, 9)],
    "gather": [(50, 90), (25, 45)],
}


def _msda_case(levels, seed=0, B=2, Q=9, nheads=4, P=3, hd=8):
    rng = np.random.RandomState(seed)
    L = len(levels)
    values = [rng.randn(B, h, w, nheads, hd).astype(np.float32)
              for h, w in levels]
    loc = rng.uniform(-0.2, 1.2, (B, Q, nheads, L, P, 2)).astype(np.float32)
    attn = rng.rand(B, Q, nheads, L, P).astype(np.float32)
    attn[attn < 0.15] = 0.0
    return values, loc, attn


def _flat(values):
    return torch.from_numpy(np.concatenate(
        [v.reshape(v.shape[0], -1, *v.shape[3:]) for v in values], axis=1))


@pytest.mark.parametrize("branch", sorted(MSDA_LEVELS))
def test_msda_matches_jax(branch):
    levels = MSDA_LEVELS[branch]
    assert (max(h * w for h, w in levels) > jax_msda.ONEHOT_MAX_PIXELS) == (
        branch == "gather")
    values, loc, attn = _msda_case(levels)
    want = np.asarray(jax_msda.multi_scale_deformable_attention(
        [jnp.asarray(v) for v in values], jnp.asarray(loc), jnp.asarray(attn)))
    got = msda_ops.msda_forward(
        _flat(values), levels, torch.from_numpy(loc), torch.from_numpy(attn))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("branch", sorted(MSDA_LEVELS))
def test_msda_index_list_matches_jax_on_gathered_queries(branch):
    """The compacted call: output row r of bn samples query index[bn, r]."""
    levels = MSDA_LEVELS[branch]
    values, loc, attn = _msda_case(levels, seed=1)
    rng = np.random.RandomState(2)
    index = np.stack([rng.permutation(loc.shape[1])[:5] for _ in range(2)])
    rows = np.arange(2)[:, None]
    want = np.asarray(jax_msda.multi_scale_deformable_attention(
        [jnp.asarray(v) for v in values],
        jnp.asarray(loc[rows, index]), jnp.asarray(attn[rows, index])))
    got = msda_ops.msda_forward(
        _flat(values), levels, torch.from_numpy(loc), torch.from_numpy(attn),
        torch.from_numpy(index.astype(np.int64)))
    assert got.shape == (2, 5, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


# (H, W) of the input: padded grid below / above JAX's one-hot threshold
DCN_SIZES = {"onehot": (9, 13), "gather": (40, 50)}


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("branch", sorted(DCN_SIZES))
def test_deform_conv_matches_jax(branch, stride):
    H, W = DCN_SIZES[branch]
    assert ((H + 2) * (W + 2) > jax_dcn.ONEHOT_MAX_PIXELS) == (
        branch == "gather")
    rng = np.random.RandomState(5)
    B, Cin, Cout = 2, 8, 6
    Ho = dcn_ops.output_size(H, stride, 1)
    Wo = dcn_ops.output_size(W, stride, 1)
    x = rng.randn(B, H, W, Cin).astype(np.float32)
    # offsets of a few pixels push many border taps outside the image
    off = (rng.randn(B, Ho, Wo, 9, 2) * 2.5).astype(np.float32)
    mask = rng.rand(B, Ho, Wo, 9).astype(np.float32)
    w = rng.randn(9, Cin, Cout).astype(np.float32)
    want = np.asarray(jax_dcn.deform_conv2d(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask), jnp.asarray(w),
        stride=stride, padding=1))
    w_ref = np.transpose(w.reshape(3, 3, Cin, Cout), (3, 2, 0, 1))
    got = dcn_ops.deform_conv2d(
        torch.from_numpy(x), torch.from_numpy(off), torch.from_numpy(mask),
        torch.from_numpy(np.ascontiguousarray(w_ref)), stride=stride)
    assert got.shape == want.shape == (B, Ho, Wo, Cout)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_deform_im2col_layout_is_tap_major():
    """Column k*Cin + c of the tile is channel c sampled at tap k: with
    zero offsets and a unit mask the tile is plain im2col, and
    deform_conv2d with a weight that picks (tap k, channel c) returns that
    column (the (Cout, Cin, 3, 3) weight maps to tap-major rows)."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1, 5, 6, 3).astype(np.float32))
    off = torch.zeros(1, 5, 6, 9, 2)
    mask = torch.ones(1, 5, 6, 9)
    cols = dcn_ops.deform_im2col_plain(x, off, mask)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    weight = torch.zeros(27, 3, 3, 3)  # output channel k*3 + c picks (k, c)
    for k in range(9):
        ky, kx = divmod(k, 3)
        want = xp[0, ky:ky + 5, kx:kx + 6].reshape(30, 3)
        torch.testing.assert_close(cols[:, 3 * k:3 * k + 3], want)
        for c in range(3):
            weight[3 * k + c, c, ky, kx] = 1.0
    out = dcn_ops.deform_conv2d(x, off, mask, weight)
    torch.testing.assert_close(out.reshape(30, 27), cols)


def test_wrappers_validate_inputs():
    value = torch.zeros(1, 10, 2, 4)
    loc = torch.zeros(1, 3, 2, 1, 2, 2)
    attn = torch.zeros(1, 3, 2, 1, 2)
    with pytest.raises(ValueError):
        msda_ops.msda_forward(value, [(3, 3)], loc, attn)
    with pytest.raises(TypeError):
        msda_ops.msda_forward(value, [(2, 5)], loc.double(), attn)
    with pytest.raises(TypeError):
        msda_ops.msda_forward(value, [(2, 5)], loc, attn,
                              torch.zeros(1, 2, dtype=torch.int32))
    x = torch.zeros(1, 8, 8, 4)
    weight = torch.zeros(5, 4, 3, 3)
    with pytest.raises(ValueError):
        dcn_ops.deform_im2col_plain(x, torch.zeros(1, 8, 8, 9, 2),
                                    torch.zeros(1, 8, 8, 9), stride=2)
    with pytest.raises(ValueError):
        dcn_ops.deform_conv2d(x, torch.zeros(1, 8, 8, 9, 2),
                              torch.zeros(1, 8, 8, 9), weight, stride=2)
    with pytest.raises(TypeError):
        dcn_ops.deform_conv2d(x, torch.zeros(1, 8, 8, 9, 2).double(),
                              torch.zeros(1, 8, 8, 9), weight)
    with pytest.raises(ValueError):  # a weight of another Cin
        dcn_ops.deform_conv2d(x, torch.zeros(1, 8, 8, 9, 2),
                              torch.zeros(1, 8, 8, 9), weight[:, :3])
