"""The port's CUDA kernels (forward and backward) against their plain
PyTorch versions, on the card.

Needs a CUDA device and nvcc; skips elsewhere. The module imports no JAX,
so it also runs on a machine that has only PyTorch (the repository's
conftest imports JAX, hence --noconftest there):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))  # lsa_iou_cases
from chip_smoke import (bf16_step, dcn_kinks, device_breakdown,  # noqa: E402
                        lidar_cloud, msda_kinks, pretest_skips, scan_order)
from graph_detr4d_tpu_torch.ops import deform_conv as dcn_ops  # noqa: E402
from graph_detr4d_tpu_torch.ops import focal_loss as focal_ops  # noqa: E402
from graph_detr4d_tpu_torch.ops import hungarian as lsa_ops  # noqa: E402
from graph_detr4d_tpu_torch.ops import msda as msda_ops  # noqa: E402
from graph_detr4d_tpu_torch.ops import voxelize as vox_ops  # noqa: E402
from graph_detr4d_tpu_torch.core import iou3d  # noqa: E402
from lsa_iou_cases import RESIDENT_ROWS, iou_pairs, lsa_cases  # noqa: E402

LSA_CASES = lsa_cases()
IOU_PAIRS = iou_pairs(iou3d.PRETEST_MARGIN)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_grads_close(got, want, dtype, position_kinks):
    """fp32: max abs error <= 1e-4 times the gradient's magnitude where that
    exceeds 1 (grad_loc carries a factor W from the sampling position, whose
    fp32 rounding the float64 plain version does not have); bf16: <= 2e-2
    of the magnitude. The position gradient (second tensor) skips samples
    at a kink of the bilinear derivative (chip_smoke.near_kink)."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        diff = (g.float() - w.float()).abs()
        if i == 1:
            diff = diff.masked_fill(position_kinks, 0.0)
        err = diff.max().item()
        scale = w.float().abs().max().item()
        tol = 1e-4 * max(1.0, scale) if dtype == torch.float32 else 2e-2 * scale
        assert err <= tol, (err, scale)


def _msda_inputs(rng, BN, Q, heads, hd, shapes, P, dtype, dev):
    S = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = torch.from_numpy(rng.randn(BN, S, heads, hd).astype(np.float32))
    loc = torch.from_numpy(
        rng.uniform(-0.2, 1.2, (BN, Q, heads, L, P, 2)).astype(np.float32)
    )
    attn = torch.from_numpy(rng.rand(BN, Q, heads, L, P).astype(np.float32))
    attn[attn < 0.2] = 0.0  # switched-off samples, as the projection mask
    return value.to(dev, dtype), loc.to(dev), attn.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("compact", [False, True])
def test_msda_kernel_matches_plain(cuda, dtype, compact):
    rng = np.random.RandomState(0)
    shapes = [(20, 50), (10, 25), (5, 13), (3, 7)]
    value, loc, attn = _msda_inputs(rng, 3, 37, 8, 32, shapes, 4, dtype, cuda)
    index = None
    if compact:
        perm = np.stack([rng.permutation(37)[:19] for _ in range(3)])
        index = torch.from_numpy(perm.astype(np.int64)).to(cuda)
    got = msda_ops.msda_forward(value, shapes, loc, attn, index)
    want = msda_ops.msda_forward_plain(value, shapes, loc, attn, index)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (3, 19 if compact else 37, 256)
    err = (got.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4, err
    else:
        assert err <= 2e-2 * want.float().abs().max().item(), err


def _msda_backward_case(rng, shapes, loc, BN, Q, heads, hd, P, dtype, dev,
                        compact):
    """value, attn, index (half the queries, or None) and grad_out around
    the given sampling locations."""
    value, _, attn = _msda_inputs(rng, BN, Q, heads, hd, shapes, P, dtype, dev)
    index = None
    if compact:
        perm = np.stack([rng.permutation(Q)[:Q // 2] for _ in range(BN)])
        index = torch.from_numpy(perm.astype(np.int64)).to(dev)
    R = Q // 2 if compact else Q
    grad_out = torch.from_numpy(rng.randn(BN, R, heads * hd).astype(np.float32))
    return value, loc.to(dev), attn, index, grad_out.to(dev, dtype)


def _check_msda_backward(value, shapes, loc, attn, grad_out, index, dtype):
    launches = msda_ops.backward_launches
    got = msda_ops.msda_backward(value, shapes, loc, attn, grad_out, index)
    want = msda_ops.msda_backward_plain(value, shapes, loc, attn, grad_out,
                                        index)
    torch.cuda.synchronize()
    assert msda_ops.backward_launches == launches + 1
    _assert_grads_close(got, want, dtype, msda_kinks(loc, shapes))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("compact", [False, True])
def test_msda_backward_kernel_clustered_samples(cuda, dtype, compact):
    """A trained model's samples cluster: every query of a camera looks
    around one reference point, 2 pixels' spread at each level, so most
    samples land in one grad_value tile (the 40 x 50 level's 10-row tiles:
    the point sits at row 14.5) and pile up on the same pixels."""
    rng = np.random.RandomState(17)
    shapes = [(40, 50), (20, 25), (10, 13), (5, 7)]
    BN, Q, heads, hd, P = 2, 60, 8, 32, 4
    sizes = np.array([[w, h] for h, w in shapes], np.float64)  # (x, y)
    centre = np.array([0.45, 0.375])
    loc = centre + rng.randn(BN, Q, heads, len(shapes), P, 2) * 2.0 / sizes[
        None, None, None, :, None, :]
    loc = torch.from_numpy(loc.astype(np.float32))
    value, loc, attn, index, grad_out = _msda_backward_case(
        rng, shapes, loc, BN, Q, heads, hd, P, dtype, cuda, compact)
    _check_msda_backward(value, shapes, loc, attn, grad_out, index, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msda_backward_kernel_tile_borders(cuda, dtype):
    """Samples on the borders of the grad_value tiles (hd 32: 512-pixel
    tiles; the 34 x 30 level is cut into 17-row tiles, the 3 x 700 level
    into rows and at column 512, so a sample there adds to 4 tiles) and on
    a 1-pixel-wide level."""
    rng = np.random.RandomState(19)
    shapes = [(34, 30), (3, 700), (9, 1)]
    BN, Q, heads, hd, P = 2, 40, 8, 32, 4
    loc = rng.uniform(-0.1, 1.1, (BN, Q, heads, len(shapes), P, 2))
    u = rng.rand(BN, Q, heads, P)
    border = rng.rand(BN, Q, heads, P) < 0.7
    loc[..., 0, :, 1] = np.where(border, (16 + u + 0.5) / 34, loc[..., 0, :, 1])
    loc[..., 1, :, 0] = np.where(border, (511 + u + 0.5) / 700,
                                 loc[..., 1, :, 0])
    loc[..., 1, :, 1] = np.where(border, (1 + u + 0.5) / 3, loc[..., 1, :, 1])
    loc[..., 2, :, 0] = np.where(border, u, loc[..., 2, :, 0])
    loc = torch.from_numpy(loc.astype(np.float32))
    for compact in (False, True):
        value, loc_d, attn, index, grad_out = _msda_backward_case(
            rng, shapes, loc, BN, Q, heads, hd, P, dtype, cuda, compact)
        _check_msda_backward(value, shapes, loc_d, attn, grad_out, index,
                             dtype)


@pytest.mark.cuda
def test_msda_backward_peak_is_below_the_old_fp32_buffer(cuda):
    """bf16: what the backward allocates (grad_value in value's dtype,
    grad_loc, grad_attn and the bins' workspace) stays below the fp32 copy
    of value that the col2im scheme zeroed and cast."""
    rng = np.random.RandomState(20)
    shapes = [(64, 64), (32, 32)]
    value, loc, attn = _msda_inputs(rng, 3, 40, 8, 32, shapes, 4,
                                    torch.bfloat16, cuda)
    grad_out = torch.randn(3, 40, 256, device=cuda).to(torch.bfloat16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = msda_ops.msda_backward(value, shapes, loc, attn, grad_out)
    torch.cuda.synchronize()
    assert grads[0].dtype == torch.bfloat16
    assert torch.cuda.max_memory_allocated() - base < value.numel() * 4


# (B, H, W, Cin, Cout) of the K2 cases: the kernels' 16-byte paths; a
# ragged size (no tile divides the pixel count, Cin and Cout off the
# stage and tile widths); Cin and Cout not multiples of 8 (scalar gather
# and stores); Cout over two 256-wide tiles and Cin over two stages
DCN_CASES = {
    "main": (2, 13, 21, 48, 64),
    "ragged": (1, 11, 13, 24, 40),
    "odd_channels": (1, 9, 10, 5, 7),
    "two_n_tiles": (1, 8, 9, 72, 300),
}


def _dcn_case(rng, case, stride, dtype, dev):
    """x, offsets (4 px: many taps outside the image), mask, the tap-major
    weight at the init scale 1 / sqrt(9 Cin) and grad_out."""
    B, H, W, Cin, Cout = DCN_CASES[case]
    Ho = dcn_ops.output_size(H, stride, 1)
    Wo = dcn_ops.output_size(W, stride, 1)
    arrays = (rng.randn(B, H, W, Cin), rng.randn(B, Ho, Wo, 9, 2) * 4.0,
              rng.rand(B, Ho, Wo, 9), rng.randn(9 * Cin, Cout) / np.sqrt(9 * Cin),
              rng.randn(B, Ho, Wo, Cout))
    return [torch.from_numpy(a.astype(np.float32)).to(dev, dtype) for a in arrays]


def _assert_close(got, want, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4, err
    else:
        assert err <= 2e-2 * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("case", sorted(DCN_CASES))
def test_deform_conv_forward_kernel_matches_plain(cuda, dtype, stride, case):
    x, off, mask, w, _ = _dcn_case(np.random.RandomState(1), case, stride,
                                   dtype, cuda)
    n0 = dcn_ops.forward_launches
    got = dcn_ops.deform_conv_forward(x, off, mask, w, stride)
    want = dcn_ops.deform_conv2d_plain(x, off, mask, w, stride)
    torch.cuda.synchronize()
    assert dcn_ops.forward_launches == n0 + 1
    _assert_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("compact", [False, True])
def test_msda_backward_kernel_matches_plain(cuda, dtype, compact):
    rng = np.random.RandomState(2)
    shapes = [(20, 50), (10, 25), (5, 13), (3, 7)]
    value, loc, attn = _msda_inputs(rng, 3, 37, 8, 32, shapes, 4, dtype, cuda)
    index = None
    if compact:
        perm = np.stack([rng.permutation(37)[:19] for _ in range(3)])
        index = torch.from_numpy(perm.astype(np.int64)).to(cuda)
    R = 19 if compact else 37
    grad_out = torch.from_numpy(rng.randn(3, R, 256).astype(np.float32))
    grad_out = grad_out.to(cuda, dtype)
    launches = msda_ops.backward_launches
    got = msda_ops.msda_backward(value, shapes, loc, attn, grad_out, index)
    want = msda_ops.msda_backward_plain(value, shapes, loc, attn, grad_out,
                                        index)
    torch.cuda.synchronize()
    assert msda_ops.backward_launches == launches + 1
    _assert_grads_close(got, want, dtype, msda_kinks(loc, shapes))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("case", sorted(DCN_CASES))
def test_deform_conv_backward_kernel_matches_plain(cuda, dtype, stride, case):
    x, off, mask, w, g = _dcn_case(np.random.RandomState(3), case, stride,
                                   dtype, cuda)
    launches = dcn_ops.backward_launches
    got = dcn_ops.deform_conv_backward(x, off, mask, w, g, stride)
    want = dcn_ops.deform_conv2d_backward_plain(x, off, mask, w, g, stride)
    torch.cuda.synchronize()
    assert dcn_ops.backward_launches == launches + 1
    _assert_grads_close(got, want, dtype, dcn_kinks(off, stride))
    got = dcn_ops.deform_conv_backward(x, off, mask, w, g, stride,
                                       weight_grad=False)
    assert got[3] is None
    _assert_grads_close(got[:3], want[:3], dtype, dcn_kinks(off, stride))


@pytest.mark.cuda
def test_deform_conv_kernels_take_unaligned_inputs(cuda):
    """Tensors that start off a 16-byte boundary (contiguous views at an
    element offset) take the kernels' scalar paths."""
    rng = np.random.RandomState(13)
    ts = _dcn_case(rng, "main", 1, torch.bfloat16, cuda)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    x, off, mask, w, g = (shifted(t) for t in ts)
    assert x.data_ptr() % 16 and w.data_ptr() % 16 and g.data_ptr() % 16
    _assert_close(dcn_ops.deform_conv_forward(x, off, mask, w),
                  dcn_ops.deform_conv2d_plain(x, off, mask, w), torch.bfloat16)
    _assert_grads_close(dcn_ops.deform_conv_backward(x, off, mask, w, g),
                        dcn_ops.deform_conv2d_backward_plain(x, off, mask, w, g),
                        torch.bfloat16, dcn_kinks(off, 1))


@pytest.mark.cuda
def test_deform_conv_saves_no_column_tile(cuda):
    """The exact path's autograd Function saves x, offsets, mask and the
    weight: no (B*Ho*Wo, 9*Cin) tensor, nothing that large."""
    x, off, mask, _, g = _dcn_case(np.random.RandomState(14), "main", 1,
                                   torch.bfloat16, cuda)
    B, H, W, Cin = x.shape
    weight = torch.randn(64, Cin, 3, 3, device=cuda) / np.sqrt(9 * Cin)
    leaves = [t.requires_grad_() for t in (x, off, mask, weight)]
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = dcn_ops.deform_conv2d(*leaves)
    M = B * H * W
    assert (M, 9 * Cin) not in saved
    assert all(np.prod(s) < M * 9 * Cin for s in saved), saved
    n0 = dcn_ops.backward_launches
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert dcn_ops.backward_launches == n0 + 1
    assert all(t.grad is not None for t in leaves)


@pytest.mark.cuda
def test_focal_loss_kernel_matches_plain(cuda):
    rng = np.random.RandomState(5)
    layers, N, C = 6, 200, 10
    logits = torch.from_numpy((rng.randn(layers, N, C) * 3).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, C + 1, (layers, N)))
    weights = torch.from_numpy(rng.rand(layers, N).astype(np.float32))
    avg = torch.from_numpy(rng.uniform(1, 50, layers).astype(np.float32))
    logits, labels, weights, avg = (t.to(cuda) for t in (logits, labels,
                                                         weights, avg))
    launches = focal_ops.launches
    loss, grad = focal_ops.focal_loss_with_grad(logits, labels, weights, avg)
    leaf = logits.clone().requires_grad_()
    want = focal_ops.sigmoid_focal_loss_plain(leaf, labels, weights, avg)
    (want_grad,) = torch.autograd.grad(want.sum(), leaf)
    torch.cuda.synchronize()
    assert focal_ops.launches == launches + 1
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=0)
    assert (grad - want_grad).abs().max() <= 1e-5 * want_grad.abs().max()
    # autograd through the wrapper scales the saved gradient
    leaf = logits.clone().requires_grad_()
    out = focal_ops.sigmoid_focal_loss(leaf, labels, weights, avg)
    (out * torch.arange(1.0, layers + 1, device=cuda)).sum().backward()
    scaled = want_grad * torch.arange(1.0, layers + 1, device=cuda)[:, None, None]
    assert (leaf.grad - scaled).abs().max() <= 1e-5 * scaled.abs().max()


def _focal_inputs(rng, layers, N, dev, C=10):
    """Focal loss inputs with background labels, layer 0 all background."""
    logits = torch.from_numpy((rng.randn(layers, N, C) * 3).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, C + 1, (layers, N)))
    labels[0] = C
    weights = torch.from_numpy(rng.rand(layers, N).astype(np.float32))
    avg = torch.from_numpy(rng.uniform(1, 50, layers).astype(np.float32))
    return tuple(t.to(dev) for t in (logits, labels, weights, avg))


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [2.0, 1.5])
@pytest.mark.parametrize("layers", [1, 6])
def test_focal_loss_kernel_cases(cuda, gamma, layers):
    """K5 at gamma 2 (its own path) and 1.5 (the general one), 1 and 6
    layers, 1,001 queries (no multiple of any row tile), layer 0 all
    background: loss within 1e-5 relative and gradient within 1e-5 of its
    magnitude of the plain version; a second call bitwise equal."""
    args = _focal_inputs(np.random.RandomState(17), layers, 1001, cuda)
    leaf = args[0].clone().requires_grad_()
    want = focal_ops.sigmoid_focal_loss_plain(leaf, *args[1:], gamma=gamma)
    (want_grad,) = torch.autograd.grad(want.sum(), leaf)
    n0 = focal_ops.launches
    loss, grad = focal_ops.focal_loss_with_grad(*args, gamma=gamma)
    again, grad_again = focal_ops.focal_loss_with_grad(*args, gamma=gamma)
    torch.cuda.synchronize()
    assert focal_ops.launches == n0 + 2
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=0)
    assert (grad - want_grad).abs().max() <= 1e-5 * want_grad.abs().max()
    assert torch.equal(loss, again) and torch.equal(grad, grad_again)


@pytest.mark.cuda
def test_focal_loss_kernel_after_a_refused_call(cuda):
    """Calls that raise on bad shapes launch nothing, and the next call
    still gives the right loss (the kernel's cross-block state is left
    ready); one call runs one kernel and nothing else (no fill)."""
    args = _focal_inputs(np.random.RandomState(18), 6, 900, cuda)
    want = focal_ops.sigmoid_focal_loss_plain(*args)
    n0 = focal_ops.launches
    with pytest.raises(ValueError):
        focal_ops.focal_loss_with_grad(args[0], args[1][:, :899], *args[2:])
    with pytest.raises(ValueError):
        focal_ops.focal_loss_with_grad(args[0][:5], *args[1:])
    assert focal_ops.launches == n0
    loss, _ = focal_ops.focal_loss_with_grad(*args)
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=0)
    def call():
        return focal_ops.focal_loss_with_grad(*args)

    kernels = device_breakdown(call)
    assert sum(count for _, _, count in kernels) == 1, kernels
    assert _runtime_launches(call) == ["cudaLaunchKernel"]


@pytest.mark.cuda
def test_hungarian_kernel_matches_plain(cuda):
    """Random costs, planted ties (costs rounded to 0.1), nan / +-inf
    entries, num_valid from 0 to R: identical assignments."""
    rng = np.random.RandomState(6)
    P, R, C = 8, 16, 60
    cost = rng.rand(P, R, C).astype(np.float32)
    cost[1] = np.round(cost[1], 1)
    cost[2] = np.round(cost[2] * 3)
    cost[3, 2, 5], cost[3, 4, 7], cost[3, 6, 9] = np.nan, np.inf, -np.inf
    num_valid = np.array([16, 16, 16, 16, 0, 1, 9, 15], np.int32)
    cost_t = torch.from_numpy(cost).to(cuda)
    nv = torch.from_numpy(num_valid).to(cuda)
    launches = lsa_ops.launches
    got = lsa_ops.hungarian_assignment(cost_t, nv)
    want = lsa_ops.hungarian_assignment_plain(cost_t, nv)
    torch.cuda.synchronize()
    assert lsa_ops.launches == launches + 1
    assert got.dtype == torch.int32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (got[4] == -1).all() and (got[6, 9:] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("max_rows", [0, RESIDENT_ROWS])
@pytest.mark.parametrize("name", sorted(LSA_CASES))
def test_hungarian_kernel_planted_cases(cuda, monkeypatch, name, max_rows):
    """The planted problems of the CPU tests (long augmenting paths,
    num_valid around RESIDENT_ROWS, square): identical to the plain
    version with all rows resident and with RESIDENT_ROWS row slots (rows
    past them through the ring and L2)."""
    monkeypatch.setattr(lsa_ops, "_max_rows", max_rows)
    cost, num_valid = (torch.from_numpy(a) for a in LSA_CASES[name])
    want = lsa_ops.hungarian_assignment_plain(cost, num_valid)
    got = lsa_ops.hungarian_assignment(cost.to(cuda), num_valid.to(cuda))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.cuda
def test_hungarian_kernel_beyond_shared_memory(cuda):
    """The flagship's shape with every row valid: 128 rows x 900 columns,
    more rows than the 62 that shared memory holds, so rows 54-127 come
    through the ring and L2; identical to the plain version."""
    rng = np.random.RandomState(7)
    cost = torch.from_numpy(rng.rand(2, 128, 900).astype(np.float32))
    cost[1] = torch.round(cost[1] * 8) / 8
    nv = torch.tensor([128, 100], dtype=torch.int32)
    got = lsa_ops.hungarian_assignment(cost.to(cuda), nv.to(cuda))
    want = lsa_ops.hungarian_assignment_plain(cost, nv)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.cuda
def test_hungarian_kernel_takes_the_hdetr_one2many_shape(cuda):
    """H-DETR's one2many matching: 6 x 128 = 768 rows x 1,800 columns.
    num_valid 200: identical to the plain version; 768: a matching whose
    summed cost is scipy's optimum within 1e-5."""
    import scipy.optimize

    lib = lsa_ops._lib()
    assert lib.lsa_max_cols(768) >= 1800
    rng = np.random.RandomState(9)
    cost = rng.rand(2, 768, 1800).astype(np.float32)
    nv = torch.tensor([200, 768], dtype=torch.int32)
    got = lsa_ops.hungarian_assignment(torch.from_numpy(cost).to(cuda),
                                       nv.to(cuda)).cpu().numpy()
    torch.cuda.synchronize()
    want = lsa_ops.hungarian_assignment_plain(torch.from_numpy(cost[:1]),
                                              nv[:1]).numpy()
    np.testing.assert_array_equal(got[0], want[0])
    assert len(set(got[1].tolist())) == 768
    rows, cols = scipy.optimize.linear_sum_assignment(cost[1])
    np.testing.assert_allclose(
        cost[1, np.arange(768), got[1]].astype(np.float64).sum(),
        cost[1, rows, cols].astype(np.float64).sum(), rtol=1e-5)


@pytest.mark.cuda
def test_hungarian_kernel_takes_the_distill_shapes(cuda):
    """Distillation's soft matching (distill/losses.py::match_soft_targets):
    teacher rows by 900 student queries, every row solved: 4 problems of
    64 rows (the bundles' top-k) and one of 900 (--teacher-top-k 0, most
    rows read through the ring). The costs are made once on the host, as
    the soft matching builds them; identical to the plain version."""
    from graph_detr4d_tpu_torch.distill.losses import bce_cost_matrix

    rng = np.random.RandomState(11)
    for P, K in ((4, 64), (1, 900)):
        sc = torch.from_numpy(rng.randn(P, 900, 10).astype(np.float32) * 2)
        sb = torch.from_numpy(rng.randn(P, 900, 10).astype(np.float32))
        ts = torch.from_numpy(rng.rand(P, K, 10).astype(np.float32))
        tb = torch.from_numpy(rng.randn(P, K, 10).astype(np.float32))
        reg = (sb[:, :, None, :8] - tb[:, None, :, :8]).abs().sum(-1)
        cost = (bce_cost_matrix(sc, ts) + 0.25 * reg).transpose(1, 2)
        cost = cost.contiguous()
        launches = lsa_ops.launches
        got = lsa_ops.hungarian_assignment(cost.to(cuda))
        assert lsa_ops.launches == launches + 1
        want = lsa_ops.hungarian_assignment_plain(cost)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
        assert all(len(set(r.tolist())) == K for r in want)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.randn(1, 8, 8, 16, device=cuda)
    off = torch.zeros(1, 8, 8, 9, 2, device=cuda)
    mask = torch.ones(1, 8, 8, 9, device=cuda)
    w = torch.randn(144, 8, device=cuda)
    with pytest.raises(TypeError):
        dcn_ops.deform_conv_forward(x.half(), off.half(), mask.half(), w.half())
    with pytest.raises(ValueError):
        dcn_ops.deform_conv_forward(x.transpose(1, 2), off, mask, w)
    with pytest.raises(ValueError):
        dcn_ops.deform_conv_forward(x, off, mask, w.t().contiguous().t())
    # K3 reads the int8 table 16 channels at a time
    with pytest.raises(ValueError, match="multiple of 16"):
        dcn_ops.deform_conv_int8_forward(x[..., :8].contiguous(), off, mask,
                                         w[:72].contiguous())
    # the backward's resident grad_out tile: 64 pixels x 4096 fp32 channels
    # do not fit in shared memory, and the launch is refused
    wide = torch.randn(144, 4096, device=cuda)
    with pytest.raises(RuntimeError):
        dcn_ops.deform_conv_backward(x, off, mask, wide,
                                     torch.randn(1, 8, 8, 4096, device=cuda))
    value = torch.randn(1, 10, 2, 4, device=cuda)
    loc = torch.rand(1, 3, 2, 1, 2, 2, device=cuda)
    attn = torch.rand(1, 3, 2, 1, 2, device=cuda)
    with pytest.raises(TypeError):
        msda_ops.msda_forward(value, [(2, 5)], loc.double(), attn)
    with pytest.raises(ValueError):
        msda_ops.msda_forward(value, [(3, 5)], loc, attn)


@pytest.mark.cuda
def test_empty_work_launches_nothing(cuda):
    msda0, dcn0 = msda_ops.launches, dcn_ops.forward_launches
    value = torch.randn(2, 10, 2, 4, device=cuda)
    loc = torch.rand(2, 3, 2, 1, 2, 2, device=cuda)
    attn = torch.rand(2, 3, 2, 1, 2, device=cuda)
    index = torch.empty(2, 0, dtype=torch.int64, device=cuda)
    assert msda_ops.msda_forward(value, [(2, 5)], loc, attn,
                                 index).shape == (2, 0, 8)
    x = torch.randn(0, 8, 8, 16, device=cuda)
    off = torch.zeros(0, 8, 8, 9, 2, device=cuda)
    mask = torch.ones(0, 8, 8, 9, device=cuda)
    w = torch.randn(144, 8, device=cuda)
    assert dcn_ops.deform_conv_forward(x, off, mask, w).shape == (0, 8, 8, 8)
    x1, off1, mask1 = (torch.ones(1, *t.shape[1:], device=cuda)
                       for t in (x, off, mask))
    empty_cin = dcn_ops.deform_conv_forward(
        x1[..., :0], off1, mask1, w[:0])  # Cin = 0: an empty sum
    assert empty_cin.shape == (1, 8, 8, 8) and (empty_cin == 0).all()
    assert (msda_ops.launches, dcn_ops.forward_launches) == (msda0, dcn0)

    counts = (msda_ops.backward_launches, dcn_ops.backward_launches,
              focal_ops.launches, lsa_ops.launches)
    grads = msda_ops.msda_backward(value, [(2, 5)], loc, attn,
                                   torch.empty(2, 0, 8, device=cuda), index)
    assert [tuple(g.shape) for g in grads] == [(2, 10, 2, 4), (2, 3, 2, 1, 2, 2),
                                              (2, 3, 2, 1, 2)]
    assert all((g == 0).all() for g in grads)
    grads = dcn_ops.deform_conv_backward(x, off, mask, w,
                                         torch.empty(0, 8, 8, 8, device=cuda))
    assert [tuple(g.shape) for g in grads] == [(0, 8, 8, 16), (0, 8, 8, 9, 2),
                                              (0, 8, 8, 9), (144, 8)]
    assert all((g == 0).all() for g in grads)
    loss, grad = focal_ops.focal_loss_with_grad(
        torch.empty(0, 5, 10, device=cuda),
        torch.empty(0, 5, dtype=torch.int64, device=cuda),
        torch.empty(0, 5, device=cuda), torch.empty(0, device=cuda))
    assert loss.shape == (0,) and grad.shape == (0, 5, 10)
    assert lsa_ops.hungarian_assignment(
        torch.empty(0, 4, 9, device=cuda)).shape == (0, 4)
    assert (msda_ops.backward_launches, dcn_ops.backward_launches,
            focal_ops.launches, lsa_ops.launches) == counts


@pytest.mark.cuda
def test_tiny_detector_on_the_card_matches_the_cpu(cuda):
    """The whole path at a tiny width (12 cameras, 64x160, ResNet-50 +
    DCN, 2 decoder layers, fp32): kernels on the card vs the plain
    versions on the CPU, and one launch of each kernel per call site."""
    from graph_detr4d_tpu_torch import config as c
    from graph_detr4d_tpu_torch.data.synthetic import synthetic_batch
    from graph_detr4d_tpu_torch.models.detector import GraphDETR4D
    from graph_detr4d_tpu_torch.weights import init_weights

    cfg = c.ModelConfig(
        backbone=c.BackboneConfig(depth=50, use_dcn=True),
        neck=c.NeckConfig(out_channels=32),
        head=c.HeadConfig(num_query=24, embed_dims=32, num_decoder_layers=2,
                          num_heads=4, num_points=2, num_cams=12,
                          ffn_dims=64, depth_num=8, pe_num_feats=16,
                          with_detach=False, cam_capacity=0.5),
        img_size=(64, 160), bf16=False)
    cpu_model = GraphDETR4D(cfg, device="cpu")
    init_weights(cpu_model, seed=0)
    gpu_model = GraphDETR4D(cfg, device=cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    b = synthetic_batch(cfg, seed=0)
    imgs, l2i = torch.from_numpy(b["images"]), torch.from_numpy(b["lidar2img"])
    msda0, dcn0 = msda_ops.launches, dcn_ops.forward_launches
    with torch.no_grad():
        got = gpu_model.eval()(imgs.to(cuda), l2i.to(cuda))
        want = cpu_model.eval()(imgs, l2i)
    torch.cuda.synchronize()
    assert (msda_ops.launches - msda0, dcn_ops.forward_launches - dcn0) == (2, 9)
    for key in ("all_cls_scores", "all_bbox_preds"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=0,
                                   atol=1e-3)


@pytest.mark.cuda
def test_tiny_train_step_on_the_card_matches_the_cpu(cuda):
    """One fp32 train step at a tiny width (12 cameras, ResNet-50 + DCN, 2
    decoder layers, dropout 0, grid mask off): kernels on the card vs the
    plain versions on the CPU, and one launch of each kernel per call
    site. Losses within 1e-4 relative; grad_norm within 1e-3 (at these
    widths a ReLU input rounding across 0 moves the backbone's gradients,
    see tests/test_torch_train.py)."""
    import dataclasses

    from graph_detr4d_tpu_torch import config as c
    from graph_detr4d_tpu_torch.data.synthetic import synthetic_batch
    from graph_detr4d_tpu_torch.models.detector import GraphDETR4D
    from graph_detr4d_tpu_torch.train.step import TrainStep
    from graph_detr4d_tpu_torch.weights import init_weights

    cfg = c.ModelConfig(
        backbone=c.BackboneConfig(depth=50, use_dcn=True),
        neck=c.NeckConfig(out_channels=32),
        head=c.HeadConfig(num_query=24, embed_dims=32, num_decoder_layers=2,
                          num_heads=4, num_points=2, num_cams=12,
                          ffn_dims=64, depth_num=8, pe_num_feats=16,
                          dropout=0.0, cam_capacity=0.5),
        loss=c.LossConfig(max_gt=8),
        img_size=(64, 160), bf16=False)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, use_grid_mask=False))
    cpu_model = GraphDETR4D(cfg, device="cpu")
    init_weights(cpu_model, seed=0)
    gpu_model = GraphDETR4D(cfg, device=cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    b = {k: torch.from_numpy(v)
         for k, v in synthetic_batch(cfg, seed=0, num_gt=5).items()}

    def counts():
        return (msda_ops.launches, msda_ops.backward_launches,
                dcn_ops.forward_launches, dcn_ops.backward_launches,
                focal_ops.launches, lsa_ops.launches)

    before = counts()
    got = TrainStep(gpu_model, cfg).step({k: v.to(cuda) for k, v in b.items()})
    torch.cuda.synchronize()
    assert tuple(a - c for a, c in zip(counts(), before)) == (2, 2, 9, 9, 1, 1)
    want = TrainStep(cpu_model, cfg).step(b)
    for k in want:
        rtol = 1e-3 if k == "grad_norm" else 1e-4
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=rtol, atol=0,
                                   msg=k)


def _int8_case(rng, B, H, W, Cin, stride, ties=False, Cout=None):
    """x (rounding ties of the table where ties), offsets (4 px: many taps
    outside the image), mask and, with Cout, the tap-major weight at the
    init scale 1 / sqrt(9 Cin)."""
    x = rng.randn(B, H, W, Cin).astype(np.float32)
    if ties:  # x * (127 / s) lands on half-integers: rounding ties
        x = ((rng.randint(-126, 126, size=x.shape) + 0.5) / 128).astype(
            np.float32)
        x[:, 0, 0, :] = 127.0 / 128
    Ho = dcn_ops.output_size(H, stride, 1)
    Wo = dcn_ops.output_size(W, stride, 1)
    off = (rng.randn(B, Ho, Wo, 9, 2) * 4.0).astype(np.float32)
    mask = rng.rand(B, Ho, Wo, 9).astype(np.float32)
    arrays = [x, off, mask]
    if Cout is not None:
        arrays.append((rng.randn(9 * Cin, Cout) / np.sqrt(9 * Cin)).astype(
            np.float32))
    return [torch.from_numpy(a) for a in arrays]


def _assert_int8_close(got, want, dtype):
    """fp32: K2's forward tolerance, 1e-4; bf16: one bf16 step of the
    output's magnitude (both round the sampled tile to bf16 the same way
    and sum the contraction in fp32)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4, err
    else:
        assert err <= bf16_step(want.float().abs().max().item()), err


# (B, H, W, Cin, Cout) of the fused K3 cases, all on grids the int8 variant
# applies to: 40 x 50 puts 2,000 (stride 1) and 500 (stride 2) output
# pixels in an image, so 64-pixel blocks straddle images; Cout 512 is two
# N tiles; Cin 48 ends in a part stage (64-channel bf16 stages)
INT8_CASES = {
    "straddle": (3, 40, 50, 48, 64),
    "two_n_tiles": (1, 40, 48, 32, 512),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_int8_conv_kernel_matches_plain(cuda, dtype, stride, ties, case):
    """The fused K3 (amax, quantize, implicit GEMM over the int8 table)
    against deform_conv2d_int8_plain, with quantization ties."""
    B, H, W, Cin, Cout = INT8_CASES[case]
    assert dcn_ops.select_variant(H, W, "int8") == "int8"
    x, off, mask, w = (t.to(cuda, dtype) for t in _int8_case(
        np.random.RandomState(7), B, H, W, Cin, stride, ties, Cout))
    n0 = dcn_ops.int8_launches
    got = dcn_ops.deform_conv_int8_forward(x, off, mask, w, stride)
    want = dcn_ops.deform_conv2d_int8_plain(x, off, mask, w, stride)
    torch.cuda.synchronize()
    assert dcn_ops.int8_launches == n0 + 1
    _assert_int8_close(got, want, dtype)
    if dtype == torch.float32:  # the quantized function, not the exact one
        exact = dcn_ops.deform_conv2d_plain(x, off, mask, w, stride)
        assert (exact - want).abs().max().item() > 1e-3


@pytest.mark.cuda
def test_int8_conv_kernel_takes_unaligned_inputs(cuda):
    """x, offsets, mask and the weight off a 16-byte boundary (contiguous
    views at an element offset; the kernels read x, offsets and mask with
    scalar loads and their own table, scales and transposed weight), and
    Cout 20, which takes the epilogue's scalar stores."""
    ts = _int8_case(np.random.RandomState(15), 2, 40, 48, 32, 1, Cout=20)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=torch.bfloat16, device=cuda)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    x, off, mask, w = (shifted(t) for t in ts)
    assert x.data_ptr() % 16 and w.data_ptr() % 16
    _assert_int8_close(dcn_ops.deform_conv_int8_forward(x, off, mask, w),
                       dcn_ops.deform_conv2d_int8_plain(x, off, mask, w),
                       torch.bfloat16)


@pytest.mark.cuda
def test_int8_conv_saves_no_column_tile(cuda):
    """deform_conv2d(variant='int8') allocates no (B*Ho*Wo, 9*Cin) tile in
    its forward (peak memory below the tile's size) and its autograd
    Function saves x, offsets, mask and the weight only."""
    x, off, mask = (t.to(cuda, torch.bfloat16) for t in _int8_case(
        np.random.RandomState(16), 2, 40, 48, 64, 1))
    B, H, W, Cin = x.shape
    weight = (torch.randn(64, Cin, 3, 3, device=cuda) / np.sqrt(9 * Cin)).to(
        torch.bfloat16)
    leaves = [t.requires_grad_() for t in (x, off, mask, weight)]
    tile_bytes = B * H * W * 9 * Cin * x.element_size()
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = dcn_ops.deform_conv2d(*leaves, variant="int8")
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < tile_bytes / 2
    assert (B * H * W, 9 * Cin) not in saved
    assert all(np.prod(s) < B * H * W * 9 * Cin for s in saved), saved
    out.float().sum().backward()
    assert all(t.grad is not None for t in leaves)


@pytest.mark.cuda
def test_int8_conv_backward_is_the_fp_kernels(cuda):
    """deform_conv2d(variant='int8') on the card: forward through K3, the
    straight-through backward through K2's fused backward kernels (x,
    offsets, mask and weight; no K2 forward launch), equal to the CPU's
    plain route."""
    rng = np.random.RandomState(8)
    x, off, mask = _int8_case(rng, 2, 40, 48, 16, 1)
    w = torch.from_numpy(rng.randn(8, 16, 3, 3).astype(np.float32) * 0.1)
    g = torch.from_numpy(rng.randn(2, 40, 48, 8).astype(np.float32))
    grads = {}
    counts = (dcn_ops.int8_launches, dcn_ops.forward_launches,
              dcn_ops.backward_launches)
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).detach().requires_grad_() for t in (x, off, mask, w)]
        out = dcn_ops.deform_conv2d(*leaves, variant="int8")
        (out * g.to(dev)).sum().backward()
        grads[str(dev)] = [out.detach().cpu()] + [t.grad.cpu() for t in leaves]
    torch.cuda.synchronize()
    assert (dcn_ops.int8_launches - counts[0],
            dcn_ops.forward_launches - counts[1],
            dcn_ops.backward_launches - counts[2]) == (1, 0, 1)
    for got, want in zip(grads["cuda"], grads["cpu"]):
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= 1e-4 * scale


def _cloud(rng, B, P, F=5):
    pts = rng.uniform(-58.0, 58.0, (B, P, F)).astype(np.float32)
    pts[..., 2] = rng.uniform(-6.0, 4.0, (B, P))
    pts[:, :200, :2] = rng.uniform(10.0, 10.7, (B, 200, 2))  # a crowded pillar
    pts[:, :200, 2] = 0.0
    # cell borders (0.8 m cells from -51.2), and just below x0
    k = rng.randint(0, 128, (B, 100)).astype(np.float32)
    pts[:, 200:300, 0] = np.float32(-51.2) + k * np.float32(0.8)
    pts[:, 300, 0] = -51.3
    mask = (rng.rand(B, P) > 0.1).astype(np.float32)
    mask[:, :301] = 1.0
    return torch.from_numpy(pts), torch.from_numpy(mask)


PC = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)


@pytest.mark.cuda
def test_pillar_features_kernel_matches_plain(cuda):
    """K6 kernels A and B: ids exactly, the augmented rows within 1e-5 (the
    cluster means sum in float64 in both, in another order; at 58 m a
    float32 step is 3.8e-6). Sample 1 is all masked: every point goes to
    the trash cell."""
    rng = np.random.RandomState(9)
    pts, mask = _cloud(rng, 3, 5000)
    mask[1] = 0.0
    pts, mask = pts.to(cuda), mask.to(cuda)
    n0 = vox_ops.launches
    ids, aug = vox_ops.pillar_features(pts, mask, PC, (128, 128))
    want_ids, want_aug = vox_ops.pillar_features_plain(pts, mask, PC, (128, 128))
    torch.cuda.synchronize()
    assert vox_ops.launches == n0 + 1
    assert torch.equal(ids, want_ids)
    assert (ids[1] == 128 * 128).all()
    assert (ids[0, 300] == 128 * 128).item()
    assert (aug - want_aug).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [-1.0, -4.0])
def test_pillar_scatter_kernel_matches_plain(cuda, shift):
    """K6 kernel C on mixed-sign and on all-negative features, crowded and
    empty cells and the trash cell: the max exactly."""
    rng = np.random.RandomState(10)
    pts, mask = _cloud(rng, 2, 5000)
    ids, _ = vox_ops.pillar_features_plain(pts, mask, PC, (128, 128))
    feats = rng.randn(2, 5000, 64) + shift
    if shift < -2:
        feats = np.minimum(feats, -0.01)
    feats = torch.from_numpy(feats.astype(np.float32))
    feats, ids = feats.to(cuda), ids.to(cuda)
    n0 = vox_ops.scatter_launches
    got = vox_ops.pillar_scatter(feats, ids, (128, 128))
    want = vox_ops.pillar_scatter_plain(feats, ids, (128, 128))
    torch.cuda.synchronize()
    assert vox_ops.scatter_launches == n0 + 1
    assert torch.equal(got, want)
    assert (got < 0).any()
    occupied = torch.bincount(ids[0][ids[0] < 128 * 128].long(),
                              minlength=128 * 128) > 0
    assert (~occupied).any()
    cells = got[0].reshape(-1, 64)
    assert (cells[~occupied] == 0).all()
    if shift < -2:
        assert (cells[occupied] < 0).all()


def _scatter_case(case):
    """(feats (B, P, C), ids (B, P)) on the CPU for one case of the
    max-scatter's card tests (a 128 x 128 grid)."""
    rng = np.random.RandomState(16)
    hw = 128 * 128
    if case in ("scan_order", "permuted"):
        # chip_smoke's cloud at 60,000 points, as it arrives (by sweep,
        # then azimuth) and randomly permuted: the same points and
        # features, the ids computed from each order
        pts_np, mask_np = lidar_cloud(3, 60000)
        order = (scan_order(pts_np, mask_np) if case == "scan_order"
                 else rng.permutation(60000))
        pts, mask = (torch.from_numpy(a)[:, order] for a in (pts_np, mask_np))
        ids, _ = vox_ops.pillar_features_plain(pts, mask, PC, (128, 128))
        feats = rng.randn(60000, 64).astype(np.float32)[order][None]
        return torch.from_numpy(np.ascontiguousarray(feats)), ids
    pts, mask = _cloud(rng, 2, 6000)
    ids, _ = vox_ops.pillar_features_plain(pts, mask, PC, (128, 128))
    C = {"c3": 3, "c33": 33}.get(case, 64)
    feats = rng.randn(2, 6000, C).astype(np.float32)
    if case == "nonfinite":
        # a NaN of each sign, a +inf and a -inf among finite values of
        # four cells, and a cell whose points are -inf in every channel
        counts = torch.bincount(ids[0][ids[0] < hw].long(), minlength=hw)
        cells = torch.nonzero(counts >= 3).flatten()[:5].tolist()
        nan = np.float32(np.nan)
        for cell, v in zip(cells, (nan, -nan, np.inf, -np.inf)):
            feats[0, int(torch.nonzero(ids[0] == cell)[1]), 5] = v
        feats[0, (ids[0] == cells[4]).numpy()] = -np.inf
    elif case == "second_sample_trash":
        ids[1] = hw
    elif case == "crowded_cell":
        ids[0, :1000] = 5 * 128 + 7  # 1,000 points in one cell
    elif case == "relu_ties":
        feats = np.maximum(feats, 0.0)  # half the values tie at 0
    return torch.from_numpy(feats), ids


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nonfinite", "second_sample_trash", "c3",
                                  "c33", "c64", "scan_order", "permuted",
                                  "crowded_cell", "relu_ties"])
def test_pillar_scatter_kernel_cases(cuda, case):
    """K6's max-scatter forward equal to the plain version, bit for bit, on
    non-finite values (cells whose max is NaN or +inf hold 0, a -inf is
    passed over, an all -inf cell holds 0), a sample all in the trash
    cell, 3, 33 and 64 channels, one cloud in scan order and permuted, a
    cell of 1,000 points, and relu's ties at 0."""
    feats, ids = (t.to(cuda) for t in _scatter_case(case))
    n0 = vox_ops.scatter_launches
    got = vox_ops.pillar_scatter(feats, ids, (128, 128))
    want = vox_ops.pillar_scatter_plain(feats, ids, (128, 128))
    torch.cuda.synchronize()
    assert vox_ops.scatter_launches == n0 + 1
    assert torch.equal(got, want)
    if case == "second_sample_trash":
        assert (got[1] == 0).all() and (got[0] != 0).any()
    if case == "nonfinite":
        assert torch.isfinite(got).all()


def _runtime_launches(fn):
    """The CUDA runtime calls that start work on the card in one call of fn
    (after a warm-up call), by name, from a torch.profiler trace (its list
    of device kernels can miss a cooperative launch)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.name.startswith(
        ("cudaLaunch", "cuLaunch", "cudaMemset", "cudaMemcpy"))]


@pytest.mark.cuda
def test_pillar_scatter_kernel_is_one_launch(cuda):
    """One K6 scatter call launches one kernel and nothing else (no fill
    or memset)."""
    feats, ids = (t.to(cuda) for t in _scatter_case("c64"))
    calls = _runtime_launches(
        lambda: vox_ops.pillar_scatter(feats, ids, (128, 128)))
    assert calls == ["cudaLaunchCooperativeKernel"], calls


@pytest.mark.cuda
def test_pillar_scatter_kernel_odd_grid_and_unaligned_output(cuda):
    """A (5, 7) grid at 3 channels, 2 samples (210 keys: the kernel zeroes
    and decodes the last 210 % 4 one at a time) equal to the plain version;
    an output that is not 16-byte aligned is refused, not written."""
    rng = np.random.RandomState(21)
    feats = torch.from_numpy(rng.randn(2, 500, 3).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(rng.randint(0, 36, (2, 500)).astype(np.int32)).to(cuda)
    got = vox_ops.pillar_scatter(feats, ids, (5, 7))
    assert torch.equal(got, vox_ops.pillar_scatter_plain(feats, ids, (5, 7)))
    out = torch.full((2 * 35 * 3 + 1,), 7.0, device=cuda)
    err = vox_ops._lib().pillar_scatter_max(
        feats.data_ptr(), ids.data_ptr(), out.data_ptr() + 4, 2, 500, 3, 35,
        torch.cuda.current_stream(cuda).cuda_stream)
    torch.cuda.synchronize()
    assert err == 1  # cudaErrorInvalidValue
    assert (out == 7.0).all()


@pytest.mark.cuda
def test_pillar_features_kernel_is_order_free_on_a_clustered_cloud(cuda):
    """K6's features kernel on a smaller copy of chip_smoke's cloud (points
    on 60 objects, a ground plane, z outliers, a masked tail; permuted):
    ids exactly and rows within 1e-5 of the plain version, for the cloud
    and for the same points in another order, and with a bool mask."""
    pts, mask = (torch.from_numpy(a).to(cuda) for a in lidar_cloud(3, 60000))
    want_ids, want_aug = vox_ops.pillar_features_plain(pts, mask, PC, (128, 128))
    perm = torch.from_numpy(np.random.RandomState(13).permutation(60000)).to(cuda)
    cases = {"cloud": (pts, mask, slice(None)),
             "permuted": (pts[:, perm], mask[:, perm], perm),
             "bool_mask": (pts, mask > 0, slice(None))}
    for name, (p, m, order) in cases.items():
        ids, aug = vox_ops.pillar_features(p, m, PC, (128, 128))
        torch.cuda.synchronize()
        assert torch.equal(ids, want_ids[:, order]), name
        err = (aug - want_aug[:, order]).abs().max().item()
        assert err <= 1e-5, (name, err)
    crowded = torch.bincount(want_ids[0].long()).max().item()
    assert crowded > 100  # object cells take many points


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "relu", "negative", "negative_nan",
                                  "c3", "c33"])
def test_pillar_scatter_backward_kernel_matches_plain(cuda, case):
    """K6's scatter backward bit-equal to the plain backward (jax.vjp of
    the JAX op): ties (relu's zeros, and three points planted on a crowded
    cell's max), all-negative cells, the trash cell, and (cases mixed and
    negative_nan) a NaN of either sign, a +inf and a -inf in three cells
    (a cell whose max is NaN or +inf passes no gradient); 3 and 33
    channels (the tail of the kernel's two columns a lane). Then the same
    through pillar_scatter's autograd Function, one cooperative launch."""
    rng = np.random.RandomState(14)
    C = {"c3": 3, "c33": 33}.get(case, 64)
    pts, mask = _cloud(rng, 2, 5000)
    ids, _ = vox_ops.pillar_features_plain(pts, mask, PC, (128, 128))
    feats = rng.randn(2, 5000, C).astype(np.float32)
    if case == "relu":
        feats = np.maximum(feats - 0.5, 0.0)
    elif case == "negative":
        feats = np.minimum(feats - 4.0, -0.01)
    live = ids[0][ids[0] < 128 * 128].long()
    members = torch.nonzero(ids[0] == torch.bincount(live).argmax())[:, 0].numpy()
    assert len(members) >= 50  # the crowded pillar
    tied = members[:3]
    feats[0, tied, 1] = feats[0, members, 1].max() + 1.0
    nonfinite = case in ("mixed", "negative_nan")
    if nonfinite:
        nan = np.copysign(np.float32(np.nan), -1.0 if case == "negative_nan" else 1.0)
        feats[0, members[3], 7], feats[0, members[4], 8] = nan, np.inf
        feats[0, members[5], 9] = -np.inf
        assert np.signbit(feats[0, members[3], 7]) == (case == "negative_nan")
    feats, ids = torch.from_numpy(feats).to(cuda), ids.to(cuda)
    g = torch.randn(2, 128, 128, C, generator=torch.Generator().manual_seed(0))
    g = g.to(cuda)
    out = vox_ops.pillar_scatter(feats, ids, (128, 128))
    n0 = vox_ops.scatter_backward_launches
    got = vox_ops.pillar_scatter_backward(feats, ids, out, g, (128, 128))
    want = vox_ops.pillar_scatter_backward_plain(feats, ids, g, (128, 128))
    torch.cuda.synchronize()
    assert vox_ops.scatter_backward_launches == n0 + 1
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)
    assert (want[ids == 128 * 128] == 0).all()
    tied = torch.from_numpy(tied).to(cuda)
    cell = ids[0, tied[0]].long()
    torch.testing.assert_close(want[0, tied, 1],
                               (g[0].reshape(-1, C)[cell, 1] / 3).expand(3),
                               rtol=1e-6, atol=0)
    if nonfinite:  # the NaN's and the +inf's cells pass none, the -inf's does
        in_cell = torch.from_numpy(members).to(cuda)
        assert (want[0, in_cell, 7] == 0).all() and (want[0, in_cell, 8] == 0).all()
        assert want[0, in_cell, 9].abs().sum() > 0
    f = feats.clone().requires_grad_()
    out = vox_ops.pillar_scatter(f, ids, (128, 128))
    assert out.grad_fn is not None
    out.backward(g)
    torch.cuda.synchronize()
    assert vox_ops.scatter_backward_launches == n0 + 2
    assert torch.equal(f.grad, got)
    calls = _runtime_launches(
        lambda: vox_ops.pillar_scatter_backward(feats, ids, out, g, (128, 128)))
    assert calls == ["cudaLaunchCooperativeKernel"], calls


@pytest.mark.cuda
def test_lidar_kernels_without_a_backward_refuse_grad(cuda):
    """pillar_features' rows and K7 have no backward kernel: with grad
    enabled and an input that requires grad they raise, rather than return
    a result that cuts the gradient; under no_grad they run. The features
    kernel also refuses rows wider than its shared-memory staging."""
    pts, mask = (t.to(cuda) for t in _cloud(np.random.RandomState(15), 1, 500))
    leaf = pts.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        vox_ops.pillar_features(leaf, mask, PC, (128, 128))
    with torch.no_grad():
        vox_ops.pillar_features(leaf, mask, PC, (128, 128))
    boxes = torch.rand(4, 7, device=cuda) + 1.0
    with pytest.raises(RuntimeError, match="no backward"):
        iou3d.bbox_overlaps_3d(boxes.clone().requires_grad_(), boxes)
    with pytest.raises(RuntimeError, match="no backward"):
        iou3d.bbox_overlaps_3d(boxes, boxes.clone().requires_grad_())
    with torch.no_grad():
        iou3d.bbox_overlaps_3d(boxes.clone().requires_grad_(), boxes)
    # the features kernel stages a block's rows in shared memory
    with pytest.raises(ValueError, match="at most 42"):
        vox_ops.pillar_features(torch.zeros(1, 4, 43, device=cuda),
                                torch.ones(1, 4, device=cuda), PC, (8, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("case", ["hd6", "hd44", "unaligned"])
def test_msda_forward_kernel_odd_shapes(cuda, dtype, compact, case):
    """K1's forward where its vector loads and stores do not apply: a head
    width that is no multiple of 4 (6: fewer channels than a lane group
    covers; 44: more than one pass of 32), and a value tensor whose data
    starts one element past an aligned address; R = 37 rows fill no tile."""
    rng = np.random.RandomState(16)
    shapes = [(20, 50), (10, 25), (5, 13), (3, 7)]
    hd = {"hd6": 6, "hd44": 44, "unaligned": 32}[case]
    value, loc, attn = _msda_inputs(rng, 3, 37, 8, hd, shapes, 4, dtype, cuda)
    if case == "unaligned":
        buf = torch.empty(value.numel() + 1, dtype=dtype, device=cuda)
        buf[1:].copy_(value.reshape(-1))
        value = buf[1:].view(value.shape)
        assert value.data_ptr() % 16 != 0 and value.is_contiguous()
    index = None
    if compact:
        perm = np.stack([rng.permutation(37)[:23] for _ in range(3)])
        index = torch.from_numpy(perm.astype(np.int64)).to(cuda)
    n0 = msda_ops.launches
    got = msda_ops.msda_forward(value, shapes, loc, attn, index)
    want = msda_ops.msda_forward_plain(value, shapes, loc, attn, index)
    torch.cuda.synchronize()
    assert msda_ops.launches == n0 + 1
    assert got.shape == want.shape == (3, 23 if compact else 37, 8 * hd)
    err = (got.float() - want.float()).abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else 2e-2 * want.float().abs().max().item()
    assert err <= tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["iou", "iof", "bev"])
def test_iou3d_kernel_matches_plain(cuda, mode):
    """K7 on random pairs 50 m out and planted identical, touching,
    contained, 45-degree and zero-height pairs: within 1e-5 (the kernel
    repeats the plain version's float operations on the same corners)."""
    rng = np.random.RandomState(11)
    b1 = np.zeros((300, 7), np.float32)
    b1[:, :2] = rng.uniform(-50, 50, (300, 2))
    b1[:, 2] = rng.uniform(-2, 1, 300)
    b1[:, 3:6] = rng.uniform(0.5, 5.0, (300, 3))
    b1[:, 6] = rng.uniform(-np.pi, np.pi, 300)
    b2 = b1[rng.permutation(300)[:128]].copy()
    b2[:, :2] += rng.uniform(-1.5, 1.5, (128, 2))
    b2[:, 6] += rng.uniform(-0.6, 0.6, 128)
    b2[:5] = b1[:5]  # identical
    b2[5] = b1[5] + [b1[5, 3], 0, 0, 0, 0, 0, 0]  # shifted by a width
    b2[6, 6] = b1[6, 6] + np.pi / 4
    b2[7, 3:6] = b1[7, 3:6] * 0.3  # contained
    b2[7, :3], b2[7, 6] = b1[7, :3], b1[7, 6]
    b2[8, 5] = 0.0  # zero height
    b1t, b2t = torch.from_numpy(b1).to(cuda), torch.from_numpy(b2).to(cuda)
    skipped = torch.zeros(1, dtype=torch.int64, device=cuda)
    n0 = iou3d.launches
    got = iou3d.bbox_overlaps_3d(b1t, b2t, mode, skipped=skipped)
    want = iou3d.bbox_overlaps_3d_plain(b1t, b2t, mode)
    torch.cuda.synchronize()
    assert iou3d.launches == n0 + 1
    assert got.shape == (300, 128)
    assert (got - want).abs().max().item() <= 1e-5
    assert (want > 0.1).sum().item() > 100
    # the kernel's count of the pairs it did not clip is its pre-test's
    assert int(skipped) == int(pretest_skips(b1t, b2t, mode).sum()) > 30000


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["iou", "iof", "bev"])
@pytest.mark.parametrize("case", sorted(IOU_PAIRS))
def test_iou3d_kernel_planted_pairs(cuda, case, mode):
    """The planted pairs of the CPU tests (gaps around the pre-test's
    margin, touching, inside, a quarter turn) within 1e-5 of the plain
    version; the pairs the pre-test skips are exactly 0, and the kernel
    counts as many skipped pairs as chip_smoke.pretest_skips marks."""
    b1, b2 = (torch.from_numpy(a).to(cuda) for a in IOU_PAIRS[case])
    skipped = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = iou3d.bbox_overlaps_3d(b1, b2, mode, skipped=skipped)
    want = iou3d.bbox_overlaps_3d_plain(b1, b2, mode)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5
    skip = pretest_skips(b1, b2, mode)
    assert (got[skip] == 0).all() and (want[skip] == 0).all()
    assert int(skipped) == int(skip.sum())


@pytest.mark.cuda
def test_iou3d_kernel_reads_strided_boxes(cuda):
    """(M, 9) boxes and a column slice are read in place (row stride 9)."""
    rng = np.random.RandomState(13)
    wide = torch.from_numpy(rng.uniform(0.5, 3.0, (40, 9)).astype(np.float32))
    wide[:, :2] = torch.from_numpy(rng.uniform(-4, 4, (40, 2)).astype(np.float32))
    wide = wide.to(cuda)
    got = iou3d.bbox_overlaps_3d(wide[:25], wide[10:])
    want = iou3d.bbox_overlaps_3d_plain(wide[:25, :7].contiguous(),
                                        wide[10:, :7].contiguous())
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5
    assert (want > 0.1).sum().item() > 20


@pytest.mark.cuda
def test_lidar_kernels_skip_empty_work(cuda):
    counts = (vox_ops.launches, vox_ops.scatter_launches, iou3d.launches,
              dcn_ops.int8_launches)
    ids, aug = vox_ops.pillar_features(
        torch.zeros(1, 0, 5, device=cuda), torch.zeros(1, 0, device=cuda),
        PC, (8, 8))
    assert ids.shape == (1, 0) and aug.shape == (1, 0, 10)
    assert iou3d.bbox_overlaps_3d(torch.zeros(0, 7, device=cuda),
                                  torch.zeros(4, 7, device=cuda)).shape == (0, 4)
    x = torch.randn(0, 40, 48, 16, device=cuda)
    assert dcn_ops.deform_conv_int8_forward(
        x, torch.zeros(0, 40, 48, 9, 2, device=cuda),
        torch.ones(0, 40, 48, 9, device=cuda),
        torch.randn(144, 8, device=cuda)).shape == (0, 40, 48, 8)
    assert (vox_ops.launches, vox_ops.scatter_launches, iou3d.launches,
            dcn_ops.int8_launches) == counts


@pytest.mark.cuda
def test_tiny_obj_dgcnn_on_the_card_matches_the_cpu(cuda):
    """ObjDGCNN at a tiny width (30 x 22 grid, 2 decoder layers, fp32):
    kernels on the card vs the plain versions on the CPU, and one launch
    of each K6 site and one K1 launch per layer."""
    from graph_detr4d_tpu_torch.config import HeadConfig
    from graph_detr4d_tpu_torch.models.dgcnn import ObjDGCNN
    from graph_detr4d_tpu_torch.weights import init_weights

    cfg = HeadConfig(num_query=24, embed_dims=32, num_decoder_layers=2,
                     num_heads=4, num_points=2, ffn_dims=64)
    cpu_model = ObjDGCNN(cfg, (30, 22), 8, 4, device="cpu")
    init_weights(cpu_model, seed=0)
    gpu_model = ObjDGCNN(cfg, (30, 22), 8, 4, device=cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    pts, mask = _cloud(np.random.RandomState(12), 2, 3000)
    counts = (vox_ops.launches, vox_ops.scatter_launches, msda_ops.launches)
    with torch.no_grad():
        got = gpu_model.eval()(pts.to(cuda), mask.to(cuda))
        want = cpu_model.eval()(pts, mask)
    torch.cuda.synchronize()
    assert (vox_ops.launches - counts[0], vox_ops.scatter_launches - counts[1],
            msda_ops.launches - counts[2]) == (1, 1, 2)
    for key in ("all_cls_scores", "all_bbox_preds"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=0,
                                   atol=1e-3)


@pytest.mark.cuda
def test_tiny_obj_dgcnn_differentiates_on_the_card_as_on_the_cpu(cuda):
    """The gradient of a fixed random projection of a tiny ObjDGCNN's head
    outputs for the pillar layers (pfn, pfn_norm): through K6's scatter
    backward and K1's backward on the card, against autograd of the plain
    versions on the CPU, within 1e-3 of each gradient's magnitude (the
    forward outputs agree within 1e-3, above); one scatter backward and a
    K1 backward per decoder layer."""
    from graph_detr4d_tpu_torch.config import HeadConfig
    from graph_detr4d_tpu_torch.models.dgcnn import ObjDGCNN
    from graph_detr4d_tpu_torch.weights import init_weights

    cfg = HeadConfig(num_query=24, embed_dims=32, num_decoder_layers=2,
                     num_heads=4, num_points=2, ffn_dims=64)
    models = {"cpu": ObjDGCNN(cfg, (30, 22), 8, 4, device="cpu")}
    init_weights(models["cpu"], seed=0)
    models["cuda"] = ObjDGCNN(cfg, (30, 22), 8, 4, device=cuda)
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    pts, mask = _cloud(np.random.RandomState(12), 2, 3000)
    gen = torch.Generator().manual_seed(3)
    proj = {k: torch.randn(2, 2, 24, 10, generator=gen)
            for k in ("all_cls_scores", "all_bbox_preds")}
    counts = (vox_ops.scatter_backward_launches, msda_ops.backward_launches)
    grads = {}
    for dev, model in models.items():
        out = model(pts.to(dev), mask.to(dev))
        sum((out[k] * p.to(dev)).sum() for k, p in proj.items()).backward()
        grads[dev] = {n: p.grad.cpu() for n, p in model.named_parameters()
                      if n.startswith("pillar_encoder.")}
    torch.cuda.synchronize()
    assert (vox_ops.scatter_backward_launches - counts[0],
            msda_ops.backward_launches - counts[1]) == (1, 2)
    assert len(grads["cuda"]) == 4
    for name, want in grads["cpu"].items():
        scale = want.abs().max().item()
        assert scale > 0, name
        err = (grads["cuda"][name] - want).abs().max().item()
        assert err <= 1e-3 * scale, (name, err, scale)
