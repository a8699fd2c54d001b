"""Planted cases for K4 (assignment) and K7 (rotated IoU), shared by the
CPU tests against the JAX package (tests/test_torch_hungarian.py,
tests/test_torch_iou3d.py) and the card tests (tests/test_torch_cuda.py).
numpy only: the card's machine has no JAX.
"""

import math

import numpy as np

# K4: a small stand-in for the kernel's resident cost rows; the card tests
# set the kernel's row slots to it, so that num_valid around it crosses
# from resident rows into the ring of rows read ahead
RESIDENT_ROWS = 12


def lsa_cases():
    """name -> (cost (P, R, C) float32, num_valid (P,) int32)."""
    rng = np.random.RandomState(21)
    cases = {}
    # long augmenting paths: row i's cost rises along the columns with
    # slope i + 1, so every new row prefers the columns already taken and
    # its augmenting path shifts every earlier row by one column (the
    # optimum: row i on column n - 1 - i)
    R, C = 30, 40
    slopes = np.arange(1, R + 1, dtype=np.float32)[:, None]
    cols = np.arange(C, dtype=np.float32)[None, :]
    steep = slopes * cols
    cases["long_paths"] = (
        np.stack([steep, steep + rng.rand(R, C).astype(np.float32) * 0.01]),
        np.array([R, R - 7], np.int32))
    # num_valid below, at and above the resident rows, and all rows
    nv = [RESIDENT_ROWS - 1, RESIDENT_ROWS, RESIDENT_ROWS + 1, 40]
    cases["resident_edge"] = (rng.rand(len(nv), 40, 64).astype(np.float32),
                              np.array(nv, np.int32))
    # square problems, random and with ties
    sq = rng.rand(3, 24, 24).astype(np.float32)
    sq[1] = np.round(sq[1] * 4) / 4
    sq[2] = np.float32(1.0)  # all tied
    cases["square"] = (sq, np.array([24, 24, 24], np.int32))
    return cases


# K7: pairs (boxes1 row, boxes2 row) of (cx, cy, cz, w, l, h, yaw)
def _box(cx=0.0, cy=0.0, cz=0.0, w=2.0, l=4.0, h=1.5, yaw=0.0):
    return [cx, cy, cz, w, l, h, yaw]


def pretest_margin(b1, b2, margin):
    """The kernel's pre-test margin for a pair: `margin` of the largest
    centre coordinate plus both bounding-circle radii."""
    r1 = 0.5 * math.hypot(b1[3], b1[4])
    r2 = 0.5 * math.hypot(b2[3], b2[4])
    scale = max(abs(b1[0]), abs(b1[1]), abs(b2[0]), abs(b2[1])) + r1 + r2
    return margin * scale


def iou_pairs(margin):
    """name -> (boxes1 (K, 7), boxes2 (K, 7)) float32, pairs row by row.

    `separated`: squares turned 45 degrees, so that a corner of each lies
    on its bounding circle and points at the other, with a gap between
    the corners (their circles) of -1, 0, 0.5, 1, 1.01, 2 and 10 pre-test
    margins and of 1 m, near the origin and 15 m out (farther out the
    shoelace's rounding over absolute coordinates parts JAX from the port
    by more than 1e-5 on the overlapping pair); the pre-test skips
    the pairs from just past one margin on."""
    q = math.pi / 4
    sep1, sep2 = [], []
    for ox, oy in ((0.0, 0.0), (12.0, -9.0)):
        for k in (-1.0, 0.0, 0.5, 1.0, 1.01, 2.0, 10.0, None):
            a = _box(ox, oy, 0.0, 2.0, 2.0, 1.5, q)
            b = _box(ox, oy, 0.2, 3.0, 3.0, 1.0, q)
            reach = 0.5 * math.hypot(2.0, 2.0) + 0.5 * math.hypot(3.0, 3.0)
            # the margin at the pair's final place, found by iterating
            gap = 1.0
            for _ in range(3):
                b[0] = ox + reach + gap
                gap = 1.0 if k is None else k * pretest_margin(a, b, margin)
            b[0] = ox + reach + gap
            sep1.append(a)
            sep2.append(b)
    pairs = {"separated": (sep1, sep2)}
    w, l = 1.8, 4.5
    pairs["touching"] = (
        [_box(0, 0, 0, w, l), _box(0, 0, 0, w, l, yaw=0.4),
         _box(30, 10, 0, w, l, yaw=1.1), _box(0, 0, 0, w, l)],
        [_box(w, 0, 0, w, l), _box(w * math.cos(0.4), w * math.sin(0.4), 0, w,
                                   l, yaw=0.4),
         _box(30 + w * math.cos(1.1), 10 + w * math.sin(1.1), 0, w, l, yaw=1.1),
         _box(w, l, 0, w, l)])  # the last shares only a corner
    pairs["inside"] = (
        [_box(0, 0, 0, 4, 6, 3, 0.3), _box(20, -5, 1, 4, 6, 3, -1.2),
         _box(0, 0, 0, 1, 1, 1, 0.7)],
        [_box(0.2, -0.3, 0.1, 1, 2, 1, 1.0), _box(20.5, -5, 1, 2, 2, 1, -1.2),
         _box(0, 0, 0, 5, 5, 5, 0.0)])
    pairs["yaw_quarter_turn"] = (
        # the same box written as (w, l, yaw) and (l, w, yaw + pi/2), and
        # the same (w, l) turned a quarter (a cross)
        [_box(0, 0, 0, w, l, 1.5, 0.2), _box(25, 7, 0, w, l, 1.5, -2.0),
         _box(0, 0, 0, w, l, 1.5, 0.2)],
        [_box(0, 0, 0, l, w, 1.5, 0.2 + math.pi / 2),
         _box(25, 7, 0, l, w, 1.5, -2.0 + math.pi / 2),
         _box(0, 0, 0, w, l, 1.5, 0.2 + math.pi / 2)])
    return {k: (np.asarray(a, np.float32), np.asarray(b, np.float32))
            for k, (a, b) in pairs.items()}
