"""The benchmark of graph_detr4d_tpu_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

runs one cell of BENCHMARK.json from the root of a checkout: weights and
inputs from the seed, set-up with the cell's own shapes warmed, the
traffic's driver sending for S seconds (with --trace 1, short
instrumented and profiled windows after it), then the check of what the
window produced against the configuration's float32 reference. The last
line of standard output is the result as one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error. Without a CUDA device, or
with fewer than the cell asks for, it exits non-zero and prints no
result. See benchmark/README.md.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; known: {sorted(cells)}",
              file=sys.stderr)
        return 2
    import torch

    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    sys.path[:0] = [ROOT, BENCH_DIR]
    os.environ.setdefault("USE_FLAX", "0")
    from harness.cell import run_cell

    result, lines = run_cell(bench, args.workload, args.seed, args.seconds,
                             args.trace, "cuda", T_START)
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
