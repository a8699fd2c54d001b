"""K6, pillar voxelization, against the JAX package's
graph_detr4d_tpu/ops/voxelize.py (plain versions, CPU, fp32).

The asymmetric 8x4 grid of tests/test_golden_pillars.py (cells of 2 m x
3 m), points outside the range in x, y and z, masked points, empty cells,
points on and one float step either side of cell borders, and a point just
below x0 (it must go to the trash cell: floor, not truncation). The JAX
functions run jitted, as every JAX entry point does: there XLA turns the
division by the constant cell size into a multiplication by its float32
reciprocal, which moves some border points by a cell against eager JAX.
Cell ids must agree exactly; features within 1e-5 (the cluster means sum
in another order: float64 here, float32 in JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_detr4d_tpu.ops import voxelize as jax_vox
from graph_detr4d_tpu_torch.ops import voxelize as vox

PC_RANGE = (-8.0, -6.0, -3.0, 8.0, 6.0, 3.0)
GRID = (8, 4)
ATOL = 1e-5


def _points(seed, P=96, F=5):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-9.0, 9.0, size=(P, F)).astype(np.float32)  # x/y OOR
    pts[:, 2] = rng.uniform(-5.0, 5.0, size=P)  # z beyond (-3, 3)
    pts[:8, 0] = rng.uniform(0.2, 1.8, size=8)  # one crowded pillar
    pts[:8, 1] = rng.uniform(0.2, 2.8, size=8)
    pts[:8, 2] = rng.uniform(-2.0, 2.0, size=8)
    # cell borders: x0 + k * 2 m and y0 + k * 3 m, on and one float step
    # either side; and a point just below x0
    borders = np.float32(-8.0) + np.float32(2.0) * np.arange(8, dtype=np.float32)
    xs = np.concatenate([borders, np.nextafter(borders, np.float32(-9)),
                         np.nextafter(borders, np.float32(9)),
                         [np.float32(-8.1)]])
    ys = np.float32(-6.0) + np.float32(3.0) * (np.arange(len(xs)) % 4)
    n = len(xs)
    pts[8:8 + n, 0], pts[8:8 + n, 1], pts[8:8 + n, 2] = xs, ys, 0.0
    mask = (rng.uniform(size=P) > 0.2).astype(np.float32)
    mask[:8 + n] = 1.0
    return pts, mask


def _jax_features(pts, mask):
    def one(p, m):
        ids, inb = jax_vox.pillar_indices(p, m, PC_RANGE, GRID)
        return ids, inb, jax_vox.pillar_center_offsets(p, ids, PC_RANGE, GRID)

    ids, inb, aug = jax.jit(jax.vmap(one))(jnp.asarray(pts), jnp.asarray(mask))
    return np.asarray(ids), np.asarray(inb), np.asarray(aug)


def test_pillar_features_match_jax():
    a, b = _points(0), _points(1)
    pts = np.stack([a[0], b[0]])
    mask = np.stack([a[1], b[1]])
    mask[1, :] = 0.0  # an all-masked cloud: every point to the trash cell
    want_ids, want_inb, want_aug = _jax_features(pts, mask)
    ids, aug = vox.pillar_features(torch.from_numpy(pts), torch.from_numpy(mask),
                                   PC_RANGE, GRID)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(aug.numpy(), want_aug, rtol=0, atol=ATOL)
    # the fixture exercises what it claims
    H, W = GRID
    assert (want_ids[1] == H * W).all()
    assert ids[0, 8 + 24].item() == H * W  # x0 - 0.1 is outside
    live = want_ids[0][want_inb[0]]
    assert np.bincount(live, minlength=H * W).max() >= 8  # crowded pillar
    assert (np.bincount(live, minlength=H * W) == 0).any()  # empty cells
    z_out = (np.abs(pts[0, :, 2]) >= 3) & (np.abs(pts[0, :, 0]) < 8) & (
        np.abs(pts[0, :, 1]) < 6) & (mask[0] > 0)
    assert z_out.any() and (want_ids[0][z_out] == H * W).all()


def test_cell_ids_at_borders_follow_the_jitted_jax_op():
    """The flagship LiDAR grid (128 x 128 cells of 0.8 m): points on cell
    borders and a few float steps either side. Eager JAX, which divides,
    puts some of them in the neighbouring cell; the jitted op multiplies
    by the reciprocal, and the port agrees with it bit for bit."""
    pc, grid = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0), (128, 128)
    rng = np.random.RandomState(4)
    n = 20000
    x = np.float32(pc[0]) + rng.randint(0, 128, n).astype(np.float32) * \
        np.float32(0.8)
    for _ in range(2):  # up to 2 float steps either side
        step = rng.randint(0, 2, n).astype(bool)
        x = np.where(step, np.nextafter(x, np.where(
            rng.rand(n) < 0.5, np.float32(-60), np.float32(60))), x)
    pts = np.stack([x, rng.uniform(-51, 51, n), np.zeros(n)], -1).astype(
        np.float32)[None]
    mask = np.ones((1, n), np.float32)
    jitted = np.asarray(jax.jit(lambda p, m: jax_vox.pillar_indices(
        p[0], m[0], pc, grid)[0])(jnp.asarray(pts), jnp.asarray(mask)))
    eager = np.asarray(jax_vox.pillar_indices(
        jnp.asarray(pts[0]), jnp.asarray(mask[0]), pc, grid)[0])
    ids, _ = vox.pillar_features(torch.from_numpy(pts), torch.from_numpy(mask),
                                 pc, grid)
    np.testing.assert_array_equal(ids[0].numpy(), jitted)
    assert (eager != jitted).sum() > 100


@pytest.mark.parametrize("shift", [-0.5, -3.0])
def test_pillar_scatter_matches_jax(shift):
    """The max-scatter on mixed-sign features, and on features that are all
    negative in every occupied cell (the max must not be clipped at 0)."""
    pts, mask = _points(2)
    want_ids, _, _ = _jax_features(pts[None], mask[None])
    rng = np.random.RandomState(3)
    feats = np.minimum(rng.randn(2, pts.shape[0], 6) + shift,
                       -0.01 if shift < -1 else np.inf).astype(np.float32)
    ids = np.stack([want_ids[0], rng.permutation(want_ids[0])]).astype(np.int32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda f, i: jax_vox.pillar_scatter(f, i, GRID, reduce="max")))(
            jnp.asarray(feats), jnp.asarray(ids)))
    got = vox.pillar_scatter(torch.from_numpy(feats), torch.from_numpy(ids),
                             GRID)
    assert got.shape == (2, *GRID, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    H, W = GRID
    empty = np.bincount(ids[0][ids[0] < H * W], minlength=H * W) == 0
    assert empty.any()
    cells = got[0].reshape(H * W, 6)
    assert (cells[torch.from_numpy(empty)] == 0).all()
    assert (got < 0).any()  # a cell whose points are all negative
    if shift < -1:
        assert (cells[torch.from_numpy(~empty)] < 0).all()


@pytest.mark.parametrize("nan_sign", [1.0, -1.0])
def test_pillar_scatter_nonfinite_matches_jax(nan_sign):
    """Non-finite features: a NaN (of either sign; x86 arithmetic makes
    negative ones), a +inf and a -inf, each in one channel of one point of
    three occupied cells among finite values, and a fourth cell whose
    points are -inf in every channel. The max is NaN or +inf in the first
    two, so they hold 0; the -inf is passed over; the all -inf cell holds
    0: exactly as the jitted, vmapped JAX op (segment_max, then
    where(isfinite, ., 0))."""
    pts, mask = _points(2)
    want_ids, _, _ = _jax_features(pts[None], mask[None])
    ids = want_ids[0].astype(np.int32)
    H, W = GRID
    counts = np.bincount(ids[ids < H * W], minlength=H * W)
    cells = np.flatnonzero(counts >= 2)[:4]
    assert len(cells) == 4
    rng = np.random.RandomState(4)
    feats = rng.randn(1, pts.shape[0], 6).astype(np.float32)
    nan = np.copysign(np.float32(np.nan), np.float32(nan_sign))
    for cell, v in zip(cells[:3], (nan, np.float32(np.inf), np.float32(-np.inf))):
        feats[0, np.flatnonzero(ids == cell)[0], 2] = v
    feats[0, ids == cells[3]] = -np.inf
    assert (np.signbit(feats[np.isnan(feats)]) == (nan_sign < 0)).all()
    want = np.asarray(jax.jit(jax.vmap(
        lambda f, i: jax_vox.pillar_scatter(f, i, GRID, reduce="max")))(
            jnp.asarray(feats), jnp.asarray(ids[None])))
    got = vox.pillar_scatter(torch.from_numpy(feats),
                             torch.from_numpy(ids[None]), GRID).numpy()
    np.testing.assert_array_equal(got, want)
    out = got[0].reshape(H * W, 6)
    assert out[cells[0], 2] == 0 and out[cells[1], 2] == 0
    finite = feats[0, ids == cells[2], 2]
    assert out[cells[2], 2] == finite[np.isfinite(finite)].max()
    assert (out[cells[3]] == 0).all()


@pytest.mark.parametrize("shift", [-0.5, -3.0])
def test_pillar_scatter_backward_matches_jax_vjp(shift):
    """The max-scatter's gradient (autograd through the plain route, and
    `pillar_scatter_backward`) against jax.vjp of the jitted, vmapped JAX
    op: ties split evenly (three points planted on a cell's nonzero max,
    two on a cell's max of 0, as relu leaves many), cells all negative,
    empty cells (no gradient), trash points (none)."""
    pts, mask = _points(2)
    want_ids, _, _ = _jax_features(pts[None], mask[None])
    rng = np.random.RandomState(5)
    P, C = pts.shape[0], 6
    feats = np.minimum(rng.randn(2, P, C) + shift,
                       -0.01 if shift < -1 else np.inf).astype(np.float32)
    ids = np.stack([want_ids[0], rng.permutation(want_ids[0])]).astype(np.int32)
    H, W = GRID
    crowded = np.bincount(ids[0][ids[0] < H * W], minlength=H * W).argmax()
    members = np.flatnonzero(ids[0] == crowded)
    assert len(members) >= 3
    top = feats[0, members, 0].max() + 0.25
    feats[0, members[:3], 0] = top  # three-way tie on a nonzero max
    feats[0, members, 1] = np.minimum(feats[0, members, 1], -0.5)
    feats[0, members[:2], 1] = 0.0  # two-way tie on 0
    g = rng.randn(2, H, W, C).astype(np.float32)

    def scatter(f):
        return jax.vmap(lambda a, i: jax_vox.pillar_scatter(
            a, i, GRID, reduce="max"))(f, jnp.asarray(ids))

    want = np.asarray(jax.jit(lambda f, gg: jax.vjp(scatter, f)[1](gg)[0])(
        jnp.asarray(feats), jnp.asarray(g)))
    f = torch.from_numpy(feats).requires_grad_()
    out = vox.pillar_scatter(f, torch.from_numpy(ids), GRID)
    out.backward(torch.from_numpy(g))
    direct = vox.pillar_scatter_backward(
        torch.from_numpy(feats), torch.from_numpy(ids), out.detach(),
        torch.from_numpy(g), GRID)
    for got in (f.grad, direct):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the fixture exercises what it claims
    cell = g[0].reshape(H * W, C)[crowded]
    np.testing.assert_allclose(want[0, members[:3], 0], cell[0] / 3, rtol=1e-6)
    np.testing.assert_allclose(want[0, members[:2], 1], cell[1] / 2, rtol=1e-6)
    assert (want[ids == H * W] == 0).all() and (ids == H * W).any()
    empty = np.bincount(ids[0][ids[0] < H * W], minlength=H * W) == 0
    assert empty.any()
    if shift < -1:
        assert (out[0].reshape(H * W, C)[torch.from_numpy(~empty)][:, 2:] < 0).all()


@pytest.mark.parametrize("nan_sign", [1.0, -1.0])
def test_pillar_scatter_backward_nonfinite_matches_jax_vjp(nan_sign):
    """The gradient where the max is not finite, against jax.vjp of the
    jitted, vmapped JAX op: a NaN (either sign), a +inf and a -inf among
    finite values of three cells, and a cell all -inf. The cells whose max
    is NaN or +inf pass no gradient (0, where autograd through
    scatter_reduce_ gave NaN to the NaN's cell), the -inf is passed over
    and its cell's max gets its gradient, the all -inf cell none."""
    pts, mask = _points(2)
    want_ids, _, _ = _jax_features(pts[None], mask[None])
    ids = want_ids[0].astype(np.int32)
    H, W = GRID
    counts = np.bincount(ids[ids < H * W], minlength=H * W)
    cells = np.flatnonzero(counts >= 2)[:4]
    rng = np.random.RandomState(6)
    feats = rng.randn(1, pts.shape[0], 6).astype(np.float32)
    nan = np.copysign(np.float32(np.nan), np.float32(nan_sign))
    for cell, v in zip(cells[:3], (nan, np.float32(np.inf), np.float32(-np.inf))):
        feats[0, np.flatnonzero(ids == cell)[0], 2] = v
    feats[0, ids == cells[3]] = -np.inf
    g = rng.randn(1, H, W, 6).astype(np.float32)

    def scatter(f):
        return jax.vmap(lambda a, i: jax_vox.pillar_scatter(
            a, i, GRID, reduce="max"))(f, jnp.asarray(ids[None]))

    want = np.asarray(jax.jit(lambda f, gg: jax.vjp(scatter, f)[1](gg)[0])(
        jnp.asarray(feats), jnp.asarray(g)))
    f = torch.from_numpy(feats).requires_grad_()
    vox.pillar_scatter(f, torch.from_numpy(ids[None]), GRID).backward(
        torch.from_numpy(g))
    plain = vox.pillar_scatter_backward_plain(
        torch.from_numpy(feats), torch.from_numpy(ids[None]), torch.from_numpy(g),
        GRID)
    for got in (f.grad, plain):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    in_cell = [ids == c for c in cells]
    assert (want[0, in_cell[0], 2] == 0).all() and (want[0, in_cell[1], 2] == 0).all()
    assert np.count_nonzero(want[0, in_cell[2], 2]) == 1
    assert (want[0, in_cell[3]] == 0).all()


def test_wrappers_validate_inputs():
    pts = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError):
        vox.pillar_features(pts[0], torch.ones(4), PC_RANGE, GRID)
    with pytest.raises(TypeError):
        vox.pillar_features(pts.double(), torch.ones(1, 4), PC_RANGE, GRID)
    with pytest.raises(TypeError):
        vox.pillar_scatter(torch.zeros(1, 4, 2), torch.zeros(1, 4), GRID)
    with pytest.raises(ValueError):
        vox.pillar_scatter(torch.zeros(1, 4, 2),
                           torch.zeros(1, 5, dtype=torch.int32), GRID)
