#!/usr/bin/env python3
"""Time the port's K6 features call against its library yardstick, split
into host and device, and optionally every kernel row, for one or more
checkouts in turns on one card.

    python3 kernel_split.py [--phase-kernels] [TREE ...]

Each TREE (default: this checkout) is a directory holding the port and its
own chip_smoke.py; each runs in a process of its own, in the order given,
so `kernel_split.py --phase-kernels old . . old` times an older checkout
and this one in turns (old, new, new, old) in one run. Per tree it
prints one JSON line per measurement, tagged with the tree:
  * `pillar_features` and `index_add_` (the cell sums, the library call
    chip_smoke.py holds it against) on chip_smoke.lidar_cloud(0): CUDA-event
    ms over 20 and 200 back-to-back calls, the host's microseconds to issue
    one call, and the device time of each kernel of one call;
  * with --phase-kernels, that tree's chip_smoke.phase_kernels rows.
Needs a CUDA device; it imports no JAX.
"""

import json
import subprocess
import sys
from pathlib import Path

SPLIT = r"""
import json, sys, time
import torch
import chip_smoke as cs
from graph_detr4d_tpu_torch.config import HeadConfig
from graph_detr4d_tpu_torch.ops import build
from graph_detr4d_tpu_torch.ops import voxelize as vox

tree, phase_kernels = sys.argv[1], sys.argv[2] == "1"
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build()
dev = torch.device("cuda")
pts, mask = (torch.from_numpy(a).to(dev) for a in cs.lidar_cloud(0))
pc, grid = HeadConfig().pc_range, cs.LIDAR_GRID
ids, _ = vox.pillar_features(pts, mask, pc, grid)
seg = ids.long().reshape(-1)
xyz = pts[0, :, :3].contiguous()
sums = torch.zeros(grid[0] * grid[1] + 1, 3, device=dev)


def host_us(fn, calls=200):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


for name, fn in (("pillar_features", lambda: vox.pillar_features(pts, mask, pc, grid)),
                 ("index_add_", lambda: sums.index_add_(0, seg, xyz))):
    print(json.dumps({"tree": tree, "call": name, "event_ms_20": cs.cuda_ms(fn, 20),
                      "event_ms_200": cs.cuda_ms(fn, 200), "host_us_per_call": host_us(fn),
                      "device_ms": cs.device_breakdown(fn)}), flush=True)
if phase_kernels:
    print(json.dumps({"tree": tree, "phase_kernels": "start"}), flush=True)
    cs.phase_kernels(dev)
"""


def main(argv):
    phase_kernels = "--phase-kernels" in argv
    trees = [a for a in argv if a != "--phase-kernels"] or ["."]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    rc = 0
    for tree in trees:
        path = Path(tree).resolve()
        if not (path / "chip_smoke.py").exists():
            raise SystemExit(f"{tree}: no chip_smoke.py")
        rc |= subprocess.run([sys.executable, "-c", SPLIT, tree,
                              "1" if phase_kernels else "0"], cwd=path).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
