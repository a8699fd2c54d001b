#!/usr/bin/env python3
"""Time kernels of the port for one or more checkouts in turns on one card.

    python3 kernel_split.py [--kernels NAME[,NAME...]] [--phase-kernels]
                            [TREE ...]

Each TREE (default: this checkout) is a directory holding the port and its
own chip_smoke.py; each runs in a process of its own, in the order given,
so `kernel_split.py --kernels k6_scatter_backward old . . old` times an
older checkout and this one in turns (old, new, new, old) in one run.
The inputs are made once, from this checkout, and given to every tree.
Per tree it prints one JSON line per measurement, tagged with the tree,
each with CUDA-event ms over 20 and 200 back-to-back calls, the host's
microseconds to issue one call, the device time of each kernel of one
call (torch.profiler) and their sum (`device_ms_total`, null where the
trace does not list the tree's main kernel once: the profiler can miss a
launch). NAME is one of (default: all):
  * k6_features: `pillar_features`, and `index_add_` of the cell sums (the
    library call chip_smoke.py holds it against), on
    chip_smoke.lidar_cloud(0);
  * k6_scatter: K6's scatter forward (`pillar_scatter`, 64 channels) on
    that cloud with raw features (randn - 0.5), relu'd ones (relu(randn),
    as PillarEncoder gives them: ties at 0), and both again on the same
    cloud in scan order (chip_smoke.scan_order: by sweep, then azimuth;
    the ids computed from the sorted points); checked equal to
    `pillar_scatter_plain`;
  * k6_scatter_backward: its gradient (`pillar_scatter_backward`) in the
    same four cases, given the forward's result and a seeded grad_out;
    checked bit-equal to `pillar_scatter_backward_plain`;
  * k5: `focal_loss_with_grad` on random inputs at the flagship's shape
    (6 x 900 x 10) and on the flagship train step's own inputs (one
    Trainer step of this checkout's chip_smoke configuration, recorded
    once); loss relative and gradient errors against the plain version,
    the loss bitwise equal over two calls;
  * k4: K4 on chip_smoke.phase_kernels' uniform random costs (6 x 128 x
    900, num_valid 0-128) and on that train step's own costs; assignments
    against the plain version, Dijkstra steps of the longest problem and
    ns per step;
  * k7: K7 at both of chip_smoke.IOU_SHAPES; error against the plain
    version and, where the tree's kernel counts them, the share of pairs
    its pre-test answered without clipping.
Before the trees, each tree's CUDA sources of the named kernels are
compiled with -Xptxas -v: registers, stack frame and spill bytes of each
kernel. --phase-kernels adds each tree's chip_smoke.phase_kernels rows.
Needs a CUDA device; it imports no JAX.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

KERNELS = ("k6_features", "k6_scatter", "k6_scatter_backward", "k5", "k4",
           "k7")
SOURCES = {"k6_features": "voxelize", "k6_scatter": "voxelize",
           "k6_scatter_backward": "voxelize", "k5": "focal_loss",
           "k4": "hungarian", "k7": "iou3d"}

TREE = r"""
import json, sys, time
import numpy as np
import torch
import chip_smoke as cs
from graph_detr4d_tpu_torch.config import HeadConfig
from graph_detr4d_tpu_torch.ops import build

tree, names, inputs_path = sys.argv[1], sys.argv[2].split(","), sys.argv[3]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build()
dev = torch.device("cuda")
inputs = torch.load(inputs_path) if inputs_path else {}


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


# Device ms of the first of `kernels` (names of this kernel in any tree)
# that a cs.device_breakdown list holds once, else None: the profiler can
# miss a launch, and an empty list is not a time of 0.
def kernel_ms(device, kernels):
    for kernel in kernels:
        hits = [ms for name, ms, count in device if kernel in name and count == 1]
        if len(hits) == 1:
            return hits[0]
    return None


def timed(fn, kernels):
    device = cs.device_breakdown(fn)
    main = kernel_ms(device, kernels)
    return {"event_ms_20": cs.cuda_ms(fn, 20), "event_ms_200": cs.cuda_ms(fn, 200),
            "host_us_per_call": host_us(fn), "device_ms": device,
            "kernel_device_ms": main,
            "device_ms_total": None if main is None else sum(
                ms for _, ms, _ in device)}


def k6_cases():
    k6 = inputs["k6"]
    feats, order = k6["feats"], k6["order"]
    for case, f, ids in (("raw", feats, k6["ids"]),
                         ("relu", torch.relu(feats + 0.5), k6["ids"]),
                         ("scan_order", feats[:, order], k6["scan_ids"]),
                         ("scan_order_relu", torch.relu(feats[:, order] + 0.5),
                          k6["scan_ids"])):
        yield case, f.contiguous().to(dev), ids.to(dev)


def k6_features():
    from graph_detr4d_tpu_torch.ops import voxelize as vox
    pts, mask = (t.to(dev) for t in inputs["k6"]["cloud"])
    pc, grid = HeadConfig().pc_range, cs.LIDAR_GRID
    ids, _ = vox.pillar_features(pts, mask, pc, grid)
    seg = ids.long().reshape(-1)
    xyz = pts[0, :, :3].contiguous()
    sums = torch.zeros(grid[0] * grid[1] + 1, 3, device=dev)
    for name, fn, kernels in (
            ("pillar_features", lambda: vox.pillar_features(pts, mask, pc, grid),
             ("pillar_features_kernel",)),
            ("index_add_", lambda: sums.index_add_(0, seg, xyz), ("index",))):
        emit({"call": name, **timed(fn, kernels)})


def k6_scatter():
    from graph_detr4d_tpu_torch.ops import voxelize as vox
    for case, f, ids in k6_cases():
        fn = lambda: vox.pillar_scatter(f, ids, cs.LIDAR_GRID)
        emit({"call": "pillar_scatter", "case": case,
              "equal": torch.equal(fn(), vox.pillar_scatter_plain(f, ids, cs.LIDAR_GRID)),
              **timed(fn, ("scatter_max_kernel",))})


def k6_scatter_backward():
    from graph_detr4d_tpu_torch.ops import voxelize as vox
    g = inputs["k6"]["grad_out"].to(dev)
    for case, f, ids in k6_cases():
        out = vox.pillar_scatter(f, ids, cs.LIDAR_GRID)
        fn = lambda: vox.pillar_scatter_backward(f, ids, out, g, cs.LIDAR_GRID)
        got = fn()
        want = vox.pillar_scatter_backward_plain(f, ids, g, cs.LIDAR_GRID)
        emit({"call": "pillar_scatter_backward", "case": case,
              "equal": torch.equal(got, want),
              "max_abs_err": (got - want).abs().max().item(),
              "nonzero": int((got != 0).sum()),
              **timed(fn, ("scatter_max_backward_kernel", "scatter_max_grad_kernel"))})


def k5():
    from graph_detr4d_tpu_torch.ops import focal_loss as focal_ops
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
        emit({"call": "focal_loss", "case": case,
              "loss_rel": ((loss - want).abs() / want.abs()).max().item(),
              "grad_abs": (grad - want_grad).abs().max().item(),
              "grad_scale": want_grad.abs().max().item(),
              "bitwise_repeat": torch.equal(loss, again),
              **timed(fn, ("focal_loss_kernel",))})


def k4():
    from graph_detr4d_tpu_torch.ops import hungarian as lsa
    nv = torch.tensor([0, 1, 40, 64, 127, 128], dtype=torch.int32)
    random_cost = torch.rand(6, 128, 900, generator=torch.Generator().manual_seed(0))
    for case, cost, valid in (("random", random_cost, nv),
                              ("train_costs", *inputs["k4"])):
        cost_d, nv_d = cost.to(dev), valid.to(dev).to(torch.int32)
        want, steps = lsa.hungarian_assignment_plain(cost, valid, return_steps=True)
        fn = lambda: lsa.hungarian_assignment(cost_d, nv_d)
        rec = timed(fn, ("lsa_kernel",))
        ms = rec["kernel_device_ms"]
        emit({"call": "hungarian", "case": case,
              "mismatches": int((fn().cpu() != want).sum()),
              "longest_steps": max(steps), "steps": steps,
              "ns_per_step": None if ms is None else 1e6 * ms / max(steps), **rec})


def k7():
    from graph_detr4d_tpu_torch.core import iou3d
    rng = np.random.RandomState(0)  # as chip_smoke.kernel_iou3d draws them
    for M, N in cs.IOU_SHAPES:
        b1 = cs.random_boxes(rng, M)
        b2 = cs.random_boxes(rng, N, near=b1)
        b1, b2 = torch.from_numpy(b1).to(dev), torch.from_numpy(b2).to(dev)
        fn = lambda: iou3d.bbox_overlaps_3d(b1, b2)
        skipped = None
        if hasattr(cs, "kernel_skipped"):  # the tree's kernel counts them
            skipped = cs.kernel_skipped(b1, b2)[0] / (M * N)
        emit({"call": "iou3d", "shape": [M, N],
              "max_abs_err": (fn() - iou3d.bbox_overlaps_3d_plain(b1, b2)).abs().max().item(),
              "pretest_skipped_share": skipped, **timed(fn, ("box_overlaps_kernel",))})


for name in names:
    if name == "phase_kernels":
        emit({"phase_kernels": "start"})
        cs.phase_kernels(dev)
    else:
        globals()[name]()
"""

# The inputs every tree is given, made once from this checkout: K6's
# cloud, its ids in both orders, features and a grad_out; with k4 or k5,
# the flagship train step's K4 costs and K5 inputs (bf16 model, as phase
# train's warm-up step records them).
INPUTS = r"""
import itertools, sys, tempfile
import torch
import chip_smoke as cs
from graph_detr4d_tpu_torch.config import HeadConfig
from graph_detr4d_tpu_torch.ops import voxelize as vox

names, path = sys.argv[1].split(","), sys.argv[2]
inputs = {}
if {"k4", "k5"} & set(names):
    from graph_detr4d_tpu_torch.configs import get_config
    from graph_detr4d_tpu_torch.train.trainer import Trainer
    cfg = get_config(cs.CONFIG)
    with tempfile.TemporaryDirectory() as work_dir:
        trainer = Trainer(cfg, cs.random_state_dict(cfg),
                          itertools.repeat(cs.train_batch(cfg)), work_dir, seed=0)
        costs, focal = [], []
        with cs.record_assignments(costs), cs.record_focal_inputs(focal):
            trainer.fit(1, log_interval=1)
        trainer.close()
    (cost, nv, _), = costs
    (focal_args, focal_kw), = focal
    inputs["k4"] = (cost.cpu(), nv.cpu())
    inputs["k5"] = (tuple(t.cpu() for t in focal_args), focal_kw)
if any(n.startswith("k6") for n in names):
    pts, mask = cs.lidar_cloud(0)
    order = torch.from_numpy(cs.scan_order(pts, mask))
    pts, mask = torch.from_numpy(pts), torch.from_numpy(mask)
    pc = HeadConfig().pc_range
    ids, _ = vox.pillar_features_plain(pts, mask, pc, cs.LIDAR_GRID)
    scan_ids, _ = vox.pillar_features_plain(pts[:, order], mask[:, order], pc,
                                            cs.LIDAR_GRID)
    assert torch.equal(scan_ids, ids[:, order])
    gen = torch.Generator().manual_seed(0)
    feats = torch.randn(1, pts.shape[1], 64, generator=gen) - 0.5
    grad_out = torch.randn(1, *cs.LIDAR_GRID, 64, generator=gen)
    inputs["k6"] = {"cloud": (pts, mask), "feats": feats, "ids": ids,
                    "order": order, "scan_ids": scan_ids, "grad_out": grad_out}
torch.save(inputs, path)
"""


def ptxas_report(tree, source):
    """nvcc -Xptxas -v of one of the tree's CUDA sources: per kernel its registers, stack frame and spill bytes."""
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


def parse(argv):
    """(kernel names, trees) of a command line; names in KERNELS' order,
    then phase_kernels."""
    names, trees, it = set(), [], iter(argv)
    phase_kernels = False
    for arg in it:
        if arg == "--kernels":
            names.update(n for n in next(it, "").split(",") if n)
        elif arg.startswith("--kernels="):
            names.update(n for n in arg.split("=", 1)[1].split(",") if n)
        elif arg == "--phase-kernels":
            phase_kernels = True
        elif arg.startswith("--"):
            raise SystemExit(f"unknown option {arg}")
        else:
            trees.append(arg)
    unknown = names - set(KERNELS)
    if unknown:
        raise SystemExit(f"unknown kernels {sorted(unknown)}; choose from {KERNELS}")
    if not names and not phase_kernels:
        names = set(KERNELS)
    return ([n for n in KERNELS if n in names] + ["phase_kernels"] * phase_kernels,
            trees or ["."])


def main(argv):
    names, trees = parse(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    for tree in trees:
        if not (Path(tree) / "chip_smoke.py").exists():
            raise SystemExit(f"{tree}: no chip_smoke.py")
    rc = 0
    with tempfile.TemporaryDirectory() as tmp:
        for source in dict.fromkeys(SOURCES[n] for n in names if n in SOURCES):
            for tree in dict.fromkeys(trees):
                for k in ptxas_report(tree, source):
                    print(json.dumps({"tree": tree, "ptxas": source, **k}),
                          flush=True)
        inputs = ""
        if set(names) - {"phase_kernels"}:
            inputs = os.path.join(tmp, "inputs.pt")
            subprocess.run([sys.executable, "-c", INPUTS, ",".join(names), inputs],
                           cwd=Path(__file__).resolve().parent, check=True)
        for tree in trees:
            rc |= subprocess.run([sys.executable, "-c", TREE, tree,
                                  ",".join(names), inputs],
                                 cwd=Path(tree).resolve()).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
