#!/usr/bin/env python3
"""Time kernels of the port for one or more checkouts in turns on one card.

    python3 kernel_split.py [--k6] [--k4-k7] [--k5-k6s] [--phase-kernels]
                            [TREE ...]

Each TREE (default: this checkout) is a directory holding the port and its
own chip_smoke.py; each runs in a process of its own, in the order given,
so `kernel_split.py --k4-k7 old . . old` times an older checkout and this
one in turns (old, new, new, old) in one run. Per tree it prints one JSON
line per measurement, tagged with the tree:
  * --k6 (the default when none of --k6, --k4-k7, --k5-k6s is given):
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
  * --k5-k6s: K6's scatter forward (`pillar_scatter`, 64 channels) on
    chip_smoke.lidar_cloud(0) with raw features (randn - 0.5), relu'd ones
    (relu(randn), as PillarEncoder gives it: ties at 0), and both again on
    the same cloud in scan order (chip_smoke.scan_order: by sweep, then
    azimuth; the ids computed from the sorted points), and K5
    (`focal_loss_with_grad`) on random inputs at the flagship's shape
    (6 x 900 x 10) and on the flagship train step's own inputs (recorded
    once, as K4's costs): CUDA-event ms, host us a call, the device
    kernels of one call and their sum (null where the trace does not list
    the tree's scatter_max_kernel or focal_loss_kernel once), K6 checked
    equal to `pillar_scatter_plain`, K5 to the plain version (loss
    relative and gradient errors) and its loss bitwise equal over two
    calls. Before the
    trees, each tree's csrc/focal_loss.cu and csrc/voxelize.cu through
    -Xptxas -v;
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

tree, sections, inputs_path = sys.argv[1], sys.argv[2].split(","), sys.argv[3]
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


# Device ms of the kernel named `kernel` in a cs.device_breakdown list
# where the trace lists it once, else None: the profiler can miss a
# launch, and an empty list is not a time of 0.
def kernel_ms(device, kernel):
    hits = [ms for name, ms, count in device if kernel in name and count == 1]
    return hits[0] if len(hits) == 1 else None


# The device ms of every kernel of one call, where `kernel` is listed once
# (see kernel_ms), else None.
def call_ms(device, kernel):
    return None if kernel_ms(device, kernel) is None else sum(
        ms for _, ms, _ in device)
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
train_cost, train_nv = torch.load(inputs_path)["k4"]
for case, cost, valid in (("random", random_cost, nv),
                          ("train_costs", train_cost, train_nv)):
    cost_d, nv_d = cost.to(dev), valid.to(dev).to(torch.int32)
    want, steps = lsa.hungarian_assignment_plain(cost, valid, return_steps=True)
    fn = lambda: lsa.hungarian_assignment(cost_d, nv_d)
    mismatches = int((fn().cpu() != want).sum())
    device = cs.device_breakdown(fn)
    lsa_ms = kernel_ms(device, "lsa_kernel")
    emit({"call": "hungarian", "case": case, "mismatches": mismatches,
          "longest_steps": max(steps), "steps": steps,
          "event_ms_20": cs.cuda_ms(fn, 20), "host_us_per_call": host_us(fn),
          "device_ms": device, "kernel_device_ms": lsa_ms,
          "ns_per_step": None if lsa_ms is None else 1e6 * lsa_ms / max(steps)})
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

K5_K6S = r"""
from graph_detr4d_tpu_torch.ops import focal_loss as focal_ops
from graph_detr4d_tpu_torch.ops import voxelize as vox

inputs = torch.load(inputs_path)
k6 = inputs["k6"]
for case, f, ids in (("raw", k6["feats"], k6["ids"]),
                     ("relu", torch.relu(k6["feats"] + 0.5), k6["ids"]),
                     ("scan_order", k6["feats"][:, k6["order"]], k6["scan_ids"]),
                     ("scan_order_relu",
                      torch.relu(k6["feats"][:, k6["order"]] + 0.5),
                      k6["scan_ids"])):
    f, ids = f.contiguous().to(dev), ids.to(dev)
    fn = lambda: vox.pillar_scatter(f, ids, cs.LIDAR_GRID)
    device = cs.device_breakdown(fn)
    emit({"call": "pillar_scatter", "case": case,
          "equal": torch.equal(fn(), vox.pillar_scatter_plain(f, ids, cs.LIDAR_GRID)),
          "event_ms_20": cs.cuda_ms(fn, 20), "event_ms_200": cs.cuda_ms(fn, 200),
          "host_us_per_call": host_us(fn), "device_ms": device,
          "device_ms_total": call_ms(device, "scatter_max_kernel")})
gen = torch.Generator().manual_seed(0)  # chip_smoke.kernel_focal_loss's shape
random = ((torch.randn(6, 900, 10, generator=gen) * 3),
          torch.randint(0, 11, (6, 900), generator=gen),
          torch.rand(6, 900, generator=gen),
          torch.rand(6, generator=gen) * 40 + 1)
for case, args, kw in (("random", random, {"alpha": 0.25, "gamma": 2.0}),
                       ("train_inputs", *inputs["k5"])):
    logits, labels, weights, avg = (t.to(dev) for t in args)
    fn = lambda: focal_ops.focal_loss_with_grad(logits, labels, weights, avg,
                                                kw["alpha"], kw["gamma"])
    loss, grad = fn()
    again, _ = fn()
    leaf = logits.clone().requires_grad_()
    want = focal_ops.sigmoid_focal_loss_plain(leaf, labels, weights, avg,
                                              kw["alpha"], kw["gamma"])
    (want_grad,) = torch.autograd.grad(want.sum(), leaf)
    device = cs.device_breakdown(fn)
    emit({"call": "focal_loss", "case": case,
          "loss_rel": ((loss - want).abs() / want.abs()).max().item(),
          "grad_abs": (grad - want_grad).abs().max().item(),
          "grad_scale": want_grad.abs().max().item(),
          "bitwise_repeat": torch.equal(loss, again),
          "event_ms_20": cs.cuda_ms(fn, 20), "event_ms_200": cs.cuda_ms(fn, 200),
          "host_us_per_call": host_us(fn), "device_ms": device,
          "device_ms_total": call_ms(device, "focal_loss_kernel")})
"""

PHASE_KERNELS = r"""
emit({"phase_kernels": "start"})
cs.phase_kernels(dev)
"""

# the inputs every tree is given, made once from this checkout: the
# flagship train step's K4 costs and K5 inputs (bf16 model, as phase
# train's warm-up step records them), and K6's scatter inputs
INPUTS = r"""
import itertools, sys, tempfile
import torch
import chip_smoke as cs
from graph_detr4d_tpu_torch.config import HeadConfig
from graph_detr4d_tpu_torch.configs import get_config
from graph_detr4d_tpu_torch.ops import voxelize as vox
from graph_detr4d_tpu_torch.train.trainer import Trainer

cfg = get_config(cs.CONFIG)
with tempfile.TemporaryDirectory() as work_dir:
    trainer = Trainer(cfg, cs.random_state_dict(cfg),
                      itertools.repeat(cs.train_batch(cfg)), work_dir, seed=0)
    costs, focal = [], []
    with cs.record_assignments(costs), cs.record_focal_inputs(focal):
        trainer.fit(1, log_interval=1)
(cost, nv, _), = costs
(focal_args, focal_kw), = focal
pts, mask = cs.lidar_cloud(0)
order = torch.from_numpy(cs.scan_order(pts, mask))
pts, mask = torch.from_numpy(pts), torch.from_numpy(mask)
pc = HeadConfig().pc_range
ids, _ = vox.pillar_features_plain(pts, mask, pc, cs.LIDAR_GRID)
scan_ids, _ = vox.pillar_features_plain(pts[:, order], mask[:, order], pc,
                                        cs.LIDAR_GRID)
assert torch.equal(scan_ids, ids[:, order])
feats = torch.randn(1, pts.shape[1], 64, generator=torch.Generator().manual_seed(0)) - 0.5
torch.save({"k4": (cost.cpu(), nv.cpu()),
            "k5": (tuple(t.cpu() for t in focal_args), focal_kw),
            "k6": {"feats": feats, "ids": ids, "order": order,
                   "scan_ids": scan_ids}}, sys.argv[1])
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
    sections = [s for s in ("k6", "k4-k7", "k5-k6s")
                if f"--{s}" in flags] or ["k6"]
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
        {"k6": K6, "k4-k7": K4_K7, "k5-k6s": K5_K6S,
         "phase-kernels": PHASE_KERNELS}[s]
        for s in sections)
    sources = {"k4-k7": ("hungarian", "iou3d"),
               "k5-k6s": ("focal_loss", "voxelize")}
    rc = 0
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.pt")
        for section in sections:
            for tree in dict.fromkeys(trees):
                for source in sources.get(section, ()):
                    for k in ptxas_report(tree, source):
                        print(json.dumps({"tree": tree, "ptxas": source, **k}),
                              flush=True)
        if {"k4-k7", "k5-k6s"} & set(sections):
            subprocess.run([sys.executable, "-c", INPUTS, inputs],
                           cwd=Path(__file__).resolve().parent, check=True)
        for tree in trees:
            rc |= subprocess.run([sys.executable, "-c", code, tree,
                                  ",".join(sections), inputs],
                                 cwd=Path(tree).resolve()).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
