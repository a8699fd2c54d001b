"""Kernel-level trace diff: device time of each kernel of the full forward
from a torch.profiler trace, at one or two batch sizes, to find the
kernels that grow faster than the batch (counterpart of
tools/profile_ops.py).

    python -m graph_detr4d_tpu_torch.tools.profile_ops \\
        [--b 1 4] [--top 25] [--device cuda]

For each --b it builds the bench config of tools/profile_breakdown.py at
that batch size, records 3 eval forwards after a warm-up under
torch.profiler (CPU and CUDA activity, record_shapes=True), and prints the
device ms a forward of each bucket of kernels (`bucket`), the top --top
kernels, and their sum and the device's busy time (the union of the
kernels' intervals) beside the traced span (CUDA events around the 3
forwards). With two batch sizes B0, B1 it prints the kernels whose time
grows most past B1 / B0 times B0's: each kernel keyed by its name and the
input shapes of the operator that launched it, the first input's leading
dimension, where it is a multiple k <= 32 of the batch, written `B*k`
and the other inputs' `*`, so that the same kernel pairs across the two
traces.

The JAX tool reads an XLA xplane file and keys an HLO op by its output
type; here the trace is PyTorch's (ROADMAP Queue 3), and a kernel that
no operator claims keys by its name alone. Parsing (`kernel_records`), `aggregate` and `excess_rows` take
recorded events, apart from the tracing. On the CPU (--device cpu) the
trace holds no device time.
"""

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

STEPS = 3


def trace_forward(fn, device, steps=STEPS):
    """Call fn once, then `steps` times under torch.profiler. Returns (the
    profile, the traced span in ms: CUDA events around the calls on a
    card, wall clock on the CPU)."""
    fn()
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=activities, record_shapes=True) as prof:
        if device.type == "cuda":
            start.record()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        if device.type == "cuda":
            end.record()
            end.synchronize()
            span = start.elapsed_time(end)
        else:
            span = 1e3 * (time.perf_counter() - t0)
    return prof, span


def kernel_records(events):
    """[(kernel name, the operator that launched it, that operator's input
    shapes, device us)], one for each device event (kernel, memcpy,
    memset) of a profile's events. A device event shares its `id` (the
    CUDA correlation id) with the runtime or driver call that launched it
    (`cudaLaunchKernel`, `cuLaunchKernel`, `cudaMemcpyAsync`, ...), whose
    `cpu_parent` is the operator; a kernel launched outside any operator
    (the port's ctypes kernels) gets none."""
    launches = {e.id: e for e in events
                if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    recs = []
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        launch = launches.get(e.id)
        op = None if launch is None else launch.cpu_parent
        name, shapes = ("", ()) if op is None else (
            op.name, tuple(tuple(s) for s in op.input_shapes or ()))
        recs.append((e.name, name, shapes, float(e.time_range.elapsed_us())))
    return recs


def aggregate(records):
    """Kernel name -> device us summed over the records."""
    agg = {}
    for name, _, _, us in records:
        agg[name] = agg.get(name, 0.0) + us
    return agg


def busy_us(events):
    """Device time that at least one device event covers (the union of
    their intervals): kernels that overlap count once, where the sum of
    their times counts them twice."""
    total, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.device_type == DeviceType.CUDA):
        total += max(0.0, e - max(s, end))
        end = max(end, e)
    return total


# (bucket, substrings of a lower-cased kernel name), first match wins:
# cuDNN's implicit-GEMM convs carry `gemm` in their names too. The port's
# kernels and NCCL's go by their names; any other kernel that a
# convolution operator launched (cuDNN's FFT engine: its transforms and
# complex GEMMs) counts as conv whatever its name.
NAMED = (("msda", ("msda",)), ("deform_conv", ("deform_conv",)),
         ("nccl", ("nccl",)))
BUCKETS = (
    ("conv (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "cudnn", "fft")),
    ("gemm (cuBLAS)", ("gemm", "nvjet", "cublas", "cutlass", "xmma")),
    ("copy / memcpy", ("memcpy", "memset", "copy")),
    ("reduce", ("reduce", "softmax", "norm", "sort", "scan", "topk")),
    ("elementwise", ("elementwise",)),
)


def bucket(name: str, op: str = "") -> str:
    """The class of a kernel, by its name, or by the operator that
    launched it where that is a convolution."""
    low = name.lower()
    for label, keys in NAMED:
        if any(k in low for k in keys):
            return label
    if "conv" in op.lower():
        return "conv (cuDNN)"
    for label, keys in BUCKETS:
        if any(k in low for k in keys):
            return label
    return "other"


def signature(name, shapes, b):
    """A kernel's key across batch sizes: its name and the input shapes,
    the first input's leading dimension d written `B*{d // b}` where d %
    b == 0 and d // b <= 32 (the JAX tool's rule on its one output
    shape), the other inputs' leading dimensions `*`: at batch 1 a
    broadcast operand's 1 and a batched operand's B look alike."""
    dims = []
    for i, shape in enumerate(shapes):
        if not shape:
            continue
        s = [str(d) for d in shape]
        if i > 0:
            s[0] = "*"
        elif shape[0] % b == 0 and shape[0] // b <= 32:
            s[0] = f"B*{shape[0] // b}"
        dims.append("[" + ",".join(s) + "]")
    return " ".join([name] + dims)


def excess_rows(records0, records1, b0, b1, steps=STEPS):
    """[(B1 ms - (b1 / b0) B0 ms, B1 ms, B0 ms, signature)] a step, the
    largest excess first."""
    def by_sig(records, b):
        out = {}
        for name, _, shapes, us in records:
            s = signature(name, shapes, b)
            out[s] = out.get(s, 0.0) + us
        return out

    s0, s1 = by_sig(records0, b0), by_sig(records1, b1)
    ratio = b1 / b0
    rows = []
    for sig in set(s0) | set(s1):
        t1 = s1.get(sig, 0.0) / (steps * 1e3)
        t0 = s0.get(sig, 0.0) / (steps * 1e3)
        rows.append((t1 - ratio * t0, t1, t0, sig))
    return sorted(rows, reverse=True)


def report(records, span_ms, busy_ms, top, steps=STEPS):
    """Print the buckets a step, the top kernels and the device sum and
    busy time beside the traced span; returns {'device_ms', 'busy_ms',
    'span_ms', 'buckets' (ms a step), 'top' ([name, ms a step])}."""
    agg = aggregate(records)
    total = sum(agg.values()) / 1e3
    print(f"  device total {total:.2f} ms over {steps} forwards (busy "
          f"{busy_ms:.2f} ms), traced span {span_ms:.2f} ms")
    buckets = {}
    for name, op, _, us in records:
        key = bucket(name, op)
        buckets[key] = buckets.get(key, 0.0) + us / (steps * 1e3)
    for k, ms in sorted(buckets.items(), key=lambda kv: -kv[1]):
        print(f"  {k:14s} {ms:7.2f} ms/step")
    print(f"  -- top {top} kernels --")
    rows = sorted(agg.items(), key=lambda kv: -kv[1])[:top]
    for n, us in rows:
        print(f"  {us / (steps * 1e3):7.3f} ms/step  {n[:140]}")
    return {"device_ms": total, "busy_ms": busy_ms, "span_ms": span_ms,
            "buckets": buckets,
            "top": [[n, us / (steps * 1e3)] for n, us in rows]}


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="graph_detr4d_tpu_torch.tools.profile_ops")
    p.add_argument("--b", nargs="*", type=int, default=[1, 4])
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    from ..utils.device import resolve_device
    from .profile_breakdown import build

    args = parse_args(argv)
    device = resolve_device(args.device)
    print("device:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else device, flush=True)
    records, out = {}, {}
    for b in args.b:
        _, model, images, l2i = build(640, 1600, 6, batch_size=b,
                                      device=device)
        with torch.no_grad():
            prof, span = trace_forward(lambda: model(images, l2i), device)
        records[b] = kernel_records(prof.events())
        busy = busy_us(prof.events()) / 1e3
        del model, images, l2i, prof
        print(f"\n== B={b}")
        out[b] = report(records[b], span, busy, args.top)
    if len(args.b) == 2:
        b0, b1 = args.b
        print(f"\n== top signatures by (B={b1} - {b1 / b0:.0f}*B={b0}) "
              "excess ms/step")
        rows = excess_rows(records[b0], records[b1], b0, b1)
        for ex, t1, t0, sig in rows[: args.top]:
            print(f"  +{ex:7.2f} ms  (B{b1} {t1:7.2f} vs B{b0} {t0:6.2f})  "
                  f"{sig[:100]}")
        out["excess"] = rows[: args.top]
    return out


if __name__ == "__main__":
    main()
