"""K7, the rotated BEV / 3D IoU, against the JAX package's
graph_detr4d_tpu/core/iou3d.py (plain version, CPU, fp32).

Planted cases (identical near the origin and 40 m out, touching, rotated
by 45 degrees, contained, disjoint, zero-height, apart in z; and from
tests/lsa_iou_cases.py pairs just separated, with gaps around the
kernel's pre-test margin, touching at an edge or a corner, one box inside
the other, the same box written at yaw and at yaw + pi/2) and random
boxes, through `bbox_overlaps_3d` in both modes, `rotated_overlap_bev`,
`bbox_overlaps_nearest_3d` and `bbox_overlaps_2d`. Tolerance: 1e-5
absolute. Every pair the kernel's pre-test skips (its copy in PyTorch,
chip_smoke.pretest_skips) is exactly 0 on both sides. Both sides clip the
same polygons with the same float32 operations; they differ only in the last bit of sin / cos and in how XLA
orders the shoelace sum. The shoelace over absolute coordinates magnifies
that: for random pairs 50 m out the two sides differ by up to 5.4e-5
(measured), so the random boxes here lie within 3 m of the origin.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import pretest_skips
from graph_detr4d_tpu.core import iou3d as jax_iou
from graph_detr4d_tpu_torch.core import iou3d
from lsa_iou_cases import iou_pairs

ATOL = 1e-5
PAIRS = iou_pairs(iou3d.PRETEST_MARGIN)


def _box(cx=0.0, cy=0.0, cz=0.0, w=2.0, l=4.0, h=1.5, yaw=0.0):
    return [cx, cy, cz, w, l, h, yaw]


# name -> (boxes1, boxes2, the IoU of the first pair where it is known)
PLANTED = {
    "identical": ([_box(yaw=0.3)], [_box(yaw=0.3)], 1.0),
    # 40 m out, the shoelace over absolute coordinates cancels terms of
    # ~1600 m^2 down to 8 m^2: JAX's own answer is 0.99997 (3e-5 low), and
    # the port gives the same
    "identical_far": ([_box(40.0, -30.0, 1.0, yaw=2.0)],
                      [_box(40.0, -30.0, 1.0, yaw=2.0)], None),
    "touching": ([_box()], [_box(cx=2.0)], 0.0),
    "rot45": ([_box(w=2.0, l=2.0, h=1.0)],
              [_box(w=2.0, l=2.0, h=1.0, yaw=math.pi / 4)],
              # square vs the same square at 45 deg: octagon of area
              # 8 (sqrt2 - 1) over union 8 - that
              8 * (math.sqrt(2) - 1) / (8 - 8 * (math.sqrt(2) - 1))),
    "contained": ([_box(w=4.0, l=4.0, h=4.0)], [_box(w=1.0, l=1.0, h=1.0)],
                  1.0 / 64.0),
    "disjoint": ([_box()], [_box(cx=10.0, cy=10.0)], 0.0),
    "zero_height": ([_box(h=0.0)], [_box(h=0.0)], 0.0),
    "z_apart": ([_box(cz=0.0)], [_box(cz=5.0)], 0.0),
}


def _random_boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-3, 3, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 4.0, (n, 3))
    b[:, 6] = rng.uniform(-math.pi, math.pi, n)
    return b


def _jax_overlaps(b1, b2, mode):
    return np.asarray(jax.jit(
        lambda a, b: jax_iou.bbox_overlaps_3d(a, b, mode=mode))(
            jnp.asarray(b1), jnp.asarray(b2)))


@pytest.mark.parametrize("mode", ["iou", "iof"])
@pytest.mark.parametrize("case", sorted(PLANTED))
def test_planted_cases_match_jax(case, mode):
    b1, b2, known = PLANTED[case]
    b1, b2 = np.asarray(b1, np.float32), np.asarray(b2, np.float32)
    want = _jax_overlaps(b1, b2, mode)
    got = iou3d.bbox_overlaps_3d(torch.from_numpy(b1), torch.from_numpy(b2),
                                 mode=mode).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if mode == "iou" and known is not None:
        np.testing.assert_allclose(got[0, 0], known, rtol=0, atol=ATOL)
    if case == "identical":  # the clipping rules give exactly 1
        assert got[0, 0] == 1.0


@pytest.mark.parametrize("mode", ["iou", "iof"])
@pytest.mark.parametrize("case", sorted(PAIRS))
def test_pretest_pairs_match_jax(case, mode):
    """All pairs of each planted set: the port equals JAX within 1e-5, and
    the pairs the pre-test skips are exactly 0 on both sides (BEV areas
    too, where the skip is by the bounding circles)."""
    b1, b2 = PAIRS[case]
    t1, t2 = torch.from_numpy(b1), torch.from_numpy(b2)
    want = _jax_overlaps(b1, b2, mode)
    got = iou3d.bbox_overlaps_3d(t1, t2, mode=mode).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    skip = pretest_skips(t1, t2, mode).numpy()
    assert (want[skip] == 0).all() and (got[skip] == 0).all()
    bev_skip = pretest_skips(t1, t2, "bev").numpy()
    assert (iou3d.bbox_overlaps_3d(t1, t2, mode="bev").numpy()[bev_skip]
            == 0).all()
    diag = np.diag(got)
    if case == "separated":
        # gaps of -1, 0, 0.5, 1, 1.01, 2, 10 margins and 1 m, twice
        assert diag[0] > 0 and diag[8] > 0  # corners overlap
        skipped = np.diag(bev_skip).reshape(2, 8)[:, [0, 1, 2, 4, 5, 6, 7]]
        np.testing.assert_array_equal(skipped, [[False] * 3 + [True] * 4] * 2)
    if case == "touching":
        np.testing.assert_allclose(diag, 0.0, rtol=0, atol=ATOL)
    if case == "inside":  # boxes2 inside boxes1, then the other way
        np.testing.assert_allclose(diag[2], 1.0 if mode == "iof" else 1 / 125,
                                   rtol=0, atol=ATOL)
    if case == "yaw_quarter_turn":
        np.testing.assert_allclose(diag[:2], 1.0, rtol=0, atol=1e-4)
        # a 1.8 x 4.5 cross: 3.24 m^2 of 8.1 (IoF) or of 12.96 (IoU)
        np.testing.assert_allclose(diag[2], 0.4 if mode == "iof" else 0.25,
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["iou", "iof", "bev"])
def test_pretest_skips_only_empty_pairs(mode):
    """Random boxes 50 m out, half of them jittered copies: every pair the
    pre-test marks has an exactly empty clip (area 0) in JAX and in the
    plain version, and the pre-test marks most pairs."""
    rng = np.random.RandomState(8)
    b1 = np.zeros((60, 7), np.float32)
    b1[:, :2] = rng.uniform(-50, 50, (60, 2))
    b1[:, 2] = rng.uniform(-2, 1, 60)
    b1[:, 3:6] = rng.uniform(0.5, 5.0, (60, 3))
    b1[:, 6] = rng.uniform(-np.pi, np.pi, 60)
    b2 = b1[rng.randint(0, 60, 50)].copy()
    b2[:, :2] += rng.uniform(-4, 4, (50, 2))
    b2[:, 6] += rng.uniform(-0.6, 0.6, 50)
    t1, t2 = torch.from_numpy(b1), torch.from_numpy(b2)
    skip = pretest_skips(t1, t2, mode).numpy()
    assert skip.mean() > 0.9
    jmode = "iou" if mode == "bev" else mode
    for got in (_jax_overlaps(b1, b2, jmode),
                iou3d.bbox_overlaps_3d(t1, t2, mode=mode).numpy()):
        assert (got[skip] == 0).all()
    near = ~skip & (iou3d.bbox_overlaps_3d(t1, t2, mode=mode).numpy() > 0)
    assert near.sum() > 20  # the rest are clipped, many overlapping


@pytest.mark.parametrize("mode", ["iou", "iof"])
def test_random_boxes_match_jax(mode):
    rng = np.random.RandomState(3)
    b1, b2 = _random_boxes(rng, 37), _random_boxes(rng, 29)
    b2[:5] = b1[:5]  # some identical pairs
    want = _jax_overlaps(b1, b2, mode)
    got = iou3d.bbox_overlaps_3d(torch.from_numpy(b1), torch.from_numpy(b2),
                                 mode=mode).numpy()
    assert (want > 0.05).sum() > 100  # many overlapping pairs
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.diag(got)[:5], 1.0, rtol=0, atol=ATOL)


def test_rotated_overlap_bev_matches_jax():
    rng = np.random.RandomState(4)
    b = _random_boxes(rng, 16)
    fn = jax.jit(jax_iou.rotated_overlap_bev)
    for i in range(0, 16, 2):
        want = float(fn(jnp.asarray(b[i]), jnp.asarray(b[i + 1])))
        got = iou3d.rotated_overlap_bev(torch.from_numpy(b[i]),
                                        torch.from_numpy(b[i + 1]))
        assert got.shape == ()
        assert abs(float(got) - want) <= ATOL


@pytest.mark.parametrize("mode", ["iou", "iof"])
def test_nearest_and_2d_overlaps_match_jax(mode):
    rng = np.random.RandomState(5)
    b1, b2 = _random_boxes(rng, 11), _random_boxes(rng, 13)
    b1[0, 6], b2[0, 6] = math.pi / 2, -3 * math.pi / 4  # swapped extents
    want = np.asarray(jax_iou.bbox_overlaps_nearest_3d(
        jnp.asarray(b1), jnp.asarray(b2), mode=mode))
    got = iou3d.bbox_overlaps_nearest_3d(torch.from_numpy(b1),
                                         torch.from_numpy(b2), mode=mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    a1 = np.concatenate([b1[:, :2] - 1, b1[:, :2] + 1], 1)
    a2 = np.concatenate([b2[:, :2] - 1.5, b2[:, :2] + 0.5], 1)
    want = np.asarray(jax_iou.bbox_overlaps_2d(jnp.asarray(a1),
                                               jnp.asarray(a2), mode=mode))
    got = iou3d.bbox_overlaps_2d(torch.from_numpy(a1), torch.from_numpy(a2),
                                 mode=mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_wrapper_validates_inputs():
    b = torch.zeros(3, 7)
    with pytest.raises(ValueError):
        iou3d.bbox_overlaps_3d(b, b, mode="giou")
    with pytest.raises(TypeError):
        iou3d.bbox_overlaps_3d(b.double(), b.double())
    with pytest.raises(ValueError):
        iou3d.bbox_overlaps_3d(b[:, :5], b)
    with pytest.raises(ValueError):  # the kernel's counter is one int64
        iou3d.bbox_overlaps_3d(b, b, skipped=torch.zeros(1, dtype=torch.int32))
