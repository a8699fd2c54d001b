"""K4: exact rectangular linear-sum assignment for a batch of problems.

Counterpart of graph_detr4d_tpu/ops/hungarian.py::hungarian_assignment
(vmapped over decoder layers and images by graph_detr4d_tpu/core/losses.py):
Jonker-Volgenant shortest augmenting paths, solving only the first
`num_valid` rows of each problem, with the reference's clamp of nan/+inf
to 100 and -inf to -100. Unsolved rows get -1.

`hungarian_assignment` launches `csrc/hungarian.cu` (one thread block per
problem, every problem in one launch, the cost rows it reads resident in
shared memory, one barrier a Dijkstra step, no host sync) for a CUDA
tensor and runs `hungarian_assignment_plain`, the same algorithm as a
Python loop over rows and Dijkstra steps vectorised over the columns, for
a CPU tensor.
Both follow the JAX op's arithmetic and its tie rule (lowest column
first), so they assign identically.
"""

import ctypes
import functools
from typing import Optional

import torch

from . import build

# kernel launches made by hungarian_assignment (plain int; chip_smoke.py
# resets it before driving the main path and reads it after)
launches = 0

# cost rows the kernel keeps in shared memory, 0 for as many as fit; the
# card tests lower it to drive the ring of rows read ahead at small sizes
_max_rows = 0

_INF = 1e18  # the JAX op's _INF


@functools.cache
def _lib():
    lib = build.load("hungarian")
    lib.lsa_solve.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p
    ]
    lib.lsa_solve.restype = ctypes.c_int
    lib.lsa_max_cols.argtypes = [ctypes.c_int]
    lib.lsa_max_cols.restype = ctypes.c_int
    return lib


def _check(cost, num_valid):
    if cost.dim() != 3:
        raise ValueError(
            f"hungarian: cost must be (problems, R, C), got {tuple(cost.shape)}")
    P, R, C = cost.shape
    if R > C:
        raise ValueError(f"hungarian: needs R <= C, got {tuple(cost.shape)}")
    if num_valid is not None:
        if tuple(num_valid.shape) != (P,):
            raise ValueError(
                f"hungarian: num_valid {tuple(num_valid.shape)} != {(P,)}")
        if num_valid.device != cost.device:
            raise ValueError("hungarian: cost and num_valid on one device")


def hungarian_assignment(
    cost: torch.Tensor, num_valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Min-cost assignment of each (R, C) problem, R <= C.

    Args:
      cost: (problems, R, C) costs (cast to float32).
      num_valid: optional (problems,) integer tensor: only the first
        num_valid rows of a problem are solved. None solves every row.

    Returns col4row (problems, R) int32: the column of each row, -1 for
    rows not solved.
    """
    global launches
    _check(cost, num_valid)
    if cost.device.type == "cpu":
        return hungarian_assignment_plain(cost, num_valid)
    if cost.device.type != "cuda":
        raise ValueError(f"hungarian: unsupported device {cost.device}")
    P, R, C = cost.shape
    lib = _lib()
    if C > lib.lsa_max_cols(R):
        raise ValueError(
            f"hungarian: {C} columns exceed the kernel's {lib.lsa_max_cols(R)} "
            f"for {R} rows")
    cost = cost.float().contiguous()
    # the kernel writes every row, -1 for those it does not solve
    out = torch.empty((P, R), dtype=torch.int32, device=cost.device)
    if P == 0 or R == 0:  # nothing to launch
        return out
    nv = None if num_valid is None else num_valid.to(torch.int32).contiguous()
    err = lib.lsa_solve(
        cost.data_ptr(), None if nv is None else nv.data_ptr(), out.data_ptr(),
        P, R, C, _max_rows,
        torch.cuda.current_stream(cost.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"hungarian kernel launch failed: cudaError {err}")
    launches += 1
    return out


def hungarian_assignment_plain(cost, num_valid=None, return_steps=False):
    """The same function as `hungarian_assignment` in plain PyTorch, one
    problem after another. With return_steps it also returns the number
    of Dijkstra steps each problem took (each reads one cost row), which
    is what the kernel's work depends on."""
    _check(cost, num_valid)
    cost = torch.nan_to_num(cost.float(), nan=100.0, posinf=100.0,
                            neginf=-100.0)
    P, R, _ = cost.shape
    out = torch.full((P, R), -1, dtype=torch.int32, device=cost.device)
    steps = []
    for p in range(P):
        n = R if num_valid is None else min(int(num_valid[p]), R)
        col4row, k = _solve(cost[p], n)
        out[p] = col4row
        steps.append(k)
    return (out, steps) if return_steps else out


def _solve(cost, n):
    """JV on one (R, C) problem for rows 0..n-1, as the JAX op's
    `_solve_row` loop: vectorised over columns, float32 throughout."""
    R, C = cost.shape
    dev = cost.device
    u = torch.zeros(R, dtype=torch.float32, device=dev)
    v = torch.zeros(C, dtype=torch.float32, device=dev)
    col4row = torch.full((R,), -1, dtype=torch.int64, device=dev)
    row4col = [-1] * C
    steps = 0
    for cur in range(n):
        spc = torch.full((C,), _INF, dtype=torch.float32, device=dev)
        path = torch.full((C,), -1, dtype=torch.int64, device=dev)
        sr = torch.zeros(R, dtype=torch.bool, device=dev)
        sc = torch.zeros(C, dtype=torch.bool, device=dev)
        i, min_val, sink = cur, torch.zeros((), device=dev), -1
        while sink < 0:
            steps += 1
            sr[i] = True
            reduced = min_val + cost[i] - u[i] - v
            better = ~sc & (reduced < spc)
            spc = torch.where(better, reduced, spc)
            path = torch.where(better, i, path)
            masked = torch.where(sc, _INF, spc)
            j = int(torch.argmin(masked))  # first minimum: lowest column
            min_val = masked[j]
            sc[j] = True
            if row4col[j] < 0:
                sink = j
            else:
                i = row4col[j]
        # dual updates (rectangular_lsap dual maintenance)
        u[cur] += min_val
        other = sr.clone()
        other[cur] = False
        assigned = torch.where(col4row >= 0,
                               spc[col4row.clamp(min=0)], 0.0)
        u = torch.where(other, u + min_val - assigned, u)
        v = torch.where(sc, v - (min_val - spc), v)
        # augment along the predecessor chain
        j = sink
        while True:
            r = int(path[j])
            row4col[j] = r
            prev = int(col4row[r])
            col4row[r] = j
            if r == cur:
                break
            j = prev
    return col4row.to(torch.int32), steps
