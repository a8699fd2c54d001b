#!/usr/bin/env python3
"""Time kernels of the port for one or more checkouts in turns on one card.

    python3 kernel_split.py [--k6] [--k4-k7] [--phase-kernels] [TREE ...]

Each TREE (default: this checkout) is a directory holding the port and its
own chip_smoke.py; each runs in a process of its own, in the order given,
so `kernel_split.py --k4-k7 old . . old` times an older checkout and this
one in turns (old, new, new, old) in one run. Per tree it prints one JSON
line per measurement, tagged with the tree:
  * --k6 (the default when neither --k6 nor --k4-k7 is given):
    `pillar_features` and `index_add_` (the cell sums, the library call
    chip_smoke.py holds it against) on chip_smoke.lidar_cloud(0):
    CUDA-event ms over 20 and 200 back-to-back calls, the host's
    microseconds to issue one call, and the device time of each kernel of
    one call;
  * --k4-k7: K4 on chip_smoke.phase_kernels' uniform random costs (6 x 128
    x 900, num_valid 0-128) and on the flagship train step's own costs
    (one Trainer step of this checkout's chip_smoke configuration,
    recorded once before the trees run and given to each), and K7 at
    both of chip_smoke.IOU_SHAPES: CUDA-event ms, host us a call, the
    device kernels of one call, K4's Dijkstra steps of its longest problem
    and ns per step, K4's assignments against the plain version, K7's
    error against the plain version and, where the tree's kernel counts
    them, the share of pairs its pre-test answered without clipping.
    Before the trees, each tree's
    csrc/hungarian.cu and csrc/iou3d.cu are compiled with -Xptxas -v:
    registers, stack frame and spill bytes of each kernel;
  * --phase-kernels: that tree's chip_smoke.phase_kernels rows.
Needs a CUDA device; it imports no JAX.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

PRELUDE = r"""
import json, sys, time
import numpy as np
import torch
import chip_smoke as cs
from graph_detr4d_tpu_torch.ops import build

tree, sections, costs_path = sys.argv[1], sys.argv[2].split(","), sys.argv[3]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build()
dev = torch.device("cuda")


def host_us(fn, calls=200):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def emit(record):
    print(json.dumps({"tree": tree, **record}), flush=True)
"""

K6 = r"""
from graph_detr4d_tpu_torch.config import HeadConfig
from graph_detr4d_tpu_torch.ops import voxelize as vox

pts, mask = (torch.from_numpy(a).to(dev) for a in cs.lidar_cloud(0))
pc, grid = HeadConfig().pc_range, cs.LIDAR_GRID
ids, _ = vox.pillar_features(pts, mask, pc, grid)
seg = ids.long().reshape(-1)
xyz = pts[0, :, :3].contiguous()
sums = torch.zeros(grid[0] * grid[1] + 1, 3, device=dev)
for name, fn in (("pillar_features", lambda: vox.pillar_features(pts, mask, pc, grid)),
                 ("index_add_", lambda: sums.index_add_(0, seg, xyz))):
    emit({"call": name, "event_ms_20": cs.cuda_ms(fn, 20),
          "event_ms_200": cs.cuda_ms(fn, 200), "host_us_per_call": host_us(fn),
          "device_ms": cs.device_breakdown(fn)})
"""

K4_K7 = r"""
from graph_detr4d_tpu_torch.core import iou3d
from graph_detr4d_tpu_torch.ops import hungarian as lsa

nv = torch.tensor([0, 1, 40, 64, 127, 128], dtype=torch.int32)
random_cost = torch.rand(6, 128, 900, generator=torch.Generator().manual_seed(0))
train_cost, train_nv = torch.load(costs_path)
for case, cost, valid in (("random", random_cost, nv),
                          ("train_costs", train_cost, train_nv)):
    cost_d, nv_d = cost.to(dev), valid.to(dev).to(torch.int32)
    want, steps = lsa.hungarian_assignment_plain(cost, valid, return_steps=True)
    fn = lambda: lsa.hungarian_assignment(cost_d, nv_d)
    mismatches = int((fn().cpu() != want).sum())
    device = cs.device_breakdown(fn)
    kernel_ms = sum(ms for name, ms, _ in device if "lsa_kernel" in name)
    emit({"call": "hungarian", "case": case, "mismatches": mismatches,
          "longest_steps": max(steps), "steps": steps,
          "event_ms_20": cs.cuda_ms(fn, 20), "host_us_per_call": host_us(fn),
          "device_ms": device, "kernel_device_ms": kernel_ms,
          "ns_per_step": 1e6 * kernel_ms / max(steps)})
rng = np.random.RandomState(0)  # as chip_smoke.kernel_iou3d draws them
for M, N in cs.IOU_SHAPES:
    b1 = cs.random_boxes(rng, M)
    b2 = cs.random_boxes(rng, N, near=b1)
    b1, b2 = torch.from_numpy(b1).to(dev), torch.from_numpy(b2).to(dev)
    fn = lambda: iou3d.bbox_overlaps_3d(b1, b2)
    err = (fn() - iou3d.bbox_overlaps_3d_plain(b1, b2)).abs().max().item()
    skipped = None
    if hasattr(cs, "kernel_skipped"):  # the tree's kernel counts them
        skipped = cs.kernel_skipped(b1, b2)[0] / (M * N)
    emit({"call": "iou3d", "shape": [M, N], "max_abs_err": err,
          "event_ms_20": cs.cuda_ms(fn, 20), "event_ms_200": cs.cuda_ms(fn, 200),
          "host_us_per_call": host_us(fn), "device_ms": cs.device_breakdown(fn),
          "pretest_skipped_share": skipped})
"""

PHASE_KERNELS = r"""
emit({"phase_kernels": "start"})
cs.phase_kernels(dev)
"""

# the flagship train step's K4 costs, from this checkout (bf16, as phase
# train's warm-up step records them)
TRAIN_COSTS = r"""
import itertools, sys, tempfile
import torch
import chip_smoke as cs
from graph_detr4d_tpu_torch.configs import get_config
from graph_detr4d_tpu_torch.train.trainer import Trainer

cfg = get_config(cs.CONFIG)
with tempfile.TemporaryDirectory() as work_dir:
    trainer = Trainer(cfg, cs.random_state_dict(cfg),
                      itertools.repeat(cs.train_batch(cfg)), work_dir, seed=0)
    calls = []
    with cs.record_assignments(calls):
        trainer.fit(1, log_interval=1)
(cost, nv, _), = calls
torch.save((cost.cpu(), nv.cpu()), sys.argv[1])
"""


def ptxas_report(tree, source):
    """nvcc -Xptxas -v of one of the tree's CUDA sources: per kernel its
    registers, stack frame and spill bytes."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from graph_detr4d_tpu_torch.ops import build

    src = Path(tree).resolve() / "graph_detr4d_tpu_torch" / "csrc" / f"{source}.cu"
    with tempfile.TemporaryDirectory() as tmp:
        log = subprocess.run(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "lib.so"), str(src)],
            capture_output=True, text=True, check=True).stderr
    kernels = []
    pattern = (r"Function properties for (\S+)\s+(\d+) bytes stack frame, "
               r"(\d+) bytes spill stores, (\d+) bytes spill loads\s+"
               r"ptxas info\s+: Used (\d+) registers")
    for name, stack, stores, loads, regs in re.findall(pattern, log):
        kernels.append({"kernel": name, "registers": int(regs),
                        "stack_bytes": int(stack), "spill_store_bytes": int(stores),
                        "spill_load_bytes": int(loads)})
    return kernels


def main(argv):
    flags = {a for a in argv if a.startswith("--")}
    trees = [a for a in argv if not a.startswith("--")] or ["."]
    sections = [s for s in ("k6", "k4-k7") if f"--{s}" in flags] or ["k6"]
    if "--phase-kernels" in flags:
        sections.append("phase-kernels")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    for tree in trees:
        if not (Path(tree) / "chip_smoke.py").exists():
            raise SystemExit(f"{tree}: no chip_smoke.py")
    code = PRELUDE + "".join(
        {"k6": K6, "k4-k7": K4_K7, "phase-kernels": PHASE_KERNELS}[s]
        for s in sections)
    rc = 0
    with tempfile.TemporaryDirectory() as tmp:
        costs = os.path.join(tmp, "train_costs.pt")
        if "k4-k7" in sections:
            for tree in dict.fromkeys(trees):
                for source in ("hungarian", "iou3d"):
                    for k in ptxas_report(tree, source):
                        print(json.dumps({"tree": tree, "ptxas": source, **k}),
                              flush=True)
            subprocess.run([sys.executable, "-c", TRAIN_COSTS, costs],
                           cwd=Path(__file__).resolve().parent, check=True)
        for tree in trees:
            rc |= subprocess.run([sys.executable, "-c", code, tree,
                                  ",".join(sections), costs],
                                 cwd=Path(tree).resolve()).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
