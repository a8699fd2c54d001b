"""Training-log analysis (counterpart of tools/analyze_logs.py; reference
tools/analysis_tools/analyze_logs.py: cal_train_time and plot_curve)
over the `train_log.jsonl` that train/trainer.py writes, one JSON record
a logged step in the JAX layout (`step`, `iter_time` in s, the losses).

    python -m graph_detr4d_tpu_torch.tools.analyze_logs cal_train_time \\
        work_dirs/x/train_log.jsonl
    python -m graph_detr4d_tpu_torch.tools.analyze_logs plot_curve \\
        work_dirs/x/train_log.jsonl --keys loss loss_cls --out curves.png

Host-only: it reads a file and needs no device.
"""

import argparse
import json

import numpy as np


def load(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def cal_train_time(records) -> str:
    """Print and return the slowest, fastest and mean `iter_time` and its
    standard deviation, in the JAX tool's format."""
    times = [r["iter_time"] for r in records if "iter_time" in r]
    if not times:
        line = "no iter_time records"
    else:
        t = np.asarray(times)
        line = (f"slowest iter_time: {t.max():.4f}s  fastest: {t.min():.4f}s"
                f"  mean: {t.mean():.4f}s  std: {t.std():.4f}s")
    print(line)
    return line


def plot_curve(records, keys, out):
    """Plot each of `keys` against `step` into the image file `out`."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    for k in keys:
        xs = [r["step"] for r in records if k in r]
        ys = [r[k] for r in records if k in r]
        plt.plot(xs, ys, label=k)
    plt.xlabel("step")
    plt.legend()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"saved {out}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="graph_detr4d_tpu_torch.tools.analyze_logs")
    p.add_argument("task", choices=["cal_train_time", "plot_curve"])
    p.add_argument("log")
    p.add_argument("--keys", nargs="+", default=["loss"])
    p.add_argument("--out", default="curves.png")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    records = load(args.log)
    if args.task == "cal_train_time":
        return cal_train_time(records)
    return plot_curve(records, args.keys, args.out)


if __name__ == "__main__":
    main()
