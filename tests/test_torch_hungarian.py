"""K4, the assignment, on planted problems (tests/lsa_iou_cases.py): the
port's plain version (CPU) against the JAX package's
graph_detr4d_tpu/ops/hungarian.py and scipy.

Long augmenting paths (every new row prefers the columns already taken),
num_valid below, at and above the stand-in for the kernel's resident
rows, and square problems (random, tied, all equal). Assignments equal
the JAX op's exactly; their summed cost equals scipy's optimum within
1e-5 relative (float32 costs summed in float64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch

from graph_detr4d_tpu.ops.hungarian import hungarian_assignment as jax_lsa
from graph_detr4d_tpu_torch.ops import hungarian as lsa_ops
from lsa_iou_cases import lsa_cases

CASES = lsa_cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_planted_assignments_match_jax_and_scipy(name):
    cost, num_valid = CASES[name]
    got, steps = lsa_ops.hungarian_assignment_plain(
        torch.from_numpy(cost), torch.from_numpy(num_valid), return_steps=True)
    got = got.numpy()
    assert np.array_equal(
        lsa_ops.hungarian_assignment(torch.from_numpy(cost),
                                     torch.from_numpy(num_valid)).numpy(), got)
    for p in range(cost.shape[0]):
        n = int(num_valid[p])
        want = np.asarray(jax_lsa(jnp.asarray(cost[p]), num_valid=n))
        np.testing.assert_array_equal(got[p], want, err_msg=f"{name} {p}")
        assert (got[p, n:] == -1).all()
        assert len(set(got[p, :n].tolist())) == n  # a matching
        rows, cols = scipy.optimize.linear_sum_assignment(cost[p, :n])
        np.testing.assert_allclose(
            cost[p, np.arange(n), got[p, :n]].astype(np.float64).sum(),
            cost[p, rows, cols].astype(np.float64).sum(), rtol=1e-5)
    if name == "long_paths":
        n = int(num_valid[0])
        # the optimum reverses the rows, and row i's search runs past every
        # earlier row: at least n (n + 1) / 2 Dijkstra steps
        np.testing.assert_array_equal(got[0, :n], np.arange(n)[::-1])
        assert steps[0] >= n * (n + 1) // 2
