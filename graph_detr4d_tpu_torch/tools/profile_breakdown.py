"""Ablation timing: which stage of the forward takes the time
(counterpart of tools/profile_breakdown.py).

    python -m graph_detr4d_tpu_torch.tools.profile_breakdown \\
        [FILTER ...] [--device cuda]

Times, on the bench config (6 cameras at 640x1600, ResNet-50 with DCN,
cam_capacity 0.5, bf16, seeded random weights, one synthetic sample),
extract_feats (backbone and neck) alone, the full eval forward, and the
forward plus the NMS-free decode, each between CUDA events after a
warm-up (wall clock on the CPU), and prints one row a measurement with
the forward's `cam_overflow`, which must be 0. The rows are the JAX
tool's: `bench`, `cam_capacity off`, `no dcn`, `12-cam`, `batch-2`,
`batch-4`, `batch-4 cap off`; FILTER arguments keep the rows whose tag
holds one of them as a substring.

The JAX tool's rows that switch a TPU layout have no counterpart, since
the port runs each op as one kernel and reads none of those fields:
one-hot sampling off (`ONEHOT_MAX_PIXELS` 0), `batch-4 msda one-hot off`,
`batch-4 msda 'pair'` (`msda_impl`), `chunk6 *` (`cam_chunk`) and
`bchunk1 *` (`batch_chunk`). Its chained-scalar timing works around a TPU
runtime whose block_until_ready can return early, and has none either.
"""

import argparse
import time

import torch

ITERS = 15
WARMUP = 3


def bench_config(H, W, N, use_dcn=True, cam_capacity=0.5):
    """The JAX tool's config (`build`, :48-74) without its TPU layout
    fields: N cameras at H x W, ResNet-50 (DCN as use_dcn), bf16."""
    from ..config import BackboneConfig, HeadConfig, ModelConfig

    return ModelConfig(
        backbone=BackboneConfig(use_dcn=use_dcn),
        head=HeadConfig(num_cams=N, with_detach=False,
                        cam_capacity=cam_capacity),
        img_size=(H, W),
        bf16=True,
    )


def build(H, W, N, use_dcn=True, cam_capacity=0.5, batch_size=1,
          device="cuda"):
    """(cfg, model, images, lidar2img): bench_config's model in eval on
    `device` with seeded random weights (weights.init_weights, seed 0) and
    one synthetic batch of batch_size samples."""
    from ..data.synthetic import synthetic_batch
    from ..models.detector import GraphDETR4D
    from ..utils.device import resolve_device
    from ..weights import init_weights

    device = resolve_device(device)
    cfg = bench_config(H, W, N, use_dcn, cam_capacity)
    model = GraphDETR4D(cfg, device="cpu")
    init_weights(model, 0)
    model = model.to(device).eval()
    batch = synthetic_batch(cfg, batch_size=batch_size)
    images = torch.as_tensor(batch["images"], device=device)
    l2i = torch.as_tensor(batch["lidar2img"], device=device)
    return cfg, model, images, l2i


def timed_ms(fn, device, iters=ITERS, warmup=WARMUP):
    """Mean ms a call of fn over `iters` calls after `warmup` calls:
    between CUDA events on a card, wall clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1e3 * (time.perf_counter() - t0) / iters
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def stage_fns(cfg, model, images, l2i):
    """The three timed functions: extract_feats, the eval forward, and
    the forward plus decode_batch at the config's coder settings."""
    from ..core.coder import decode_batch

    def feats():
        return model.extract_feats(images)

    def full():
        return model(images, l2i)

    def full_decode():
        out = model(images, l2i)
        return out, decode_batch(out, max_num=cfg.coder.max_num,
                                 post_center_range=cfg.coder.post_center_range)

    return feats, full, full_decode


ABLATIONS = (
    ("bench (dcn, cap .5)", {}),
    ("cam_capacity off", dict(cam_capacity=1.0)),
    ("no dcn", dict(use_dcn=False)),
    ("12-cam (dcn, cap .5)", dict(N=12)),
    ("batch-2 (dcn, cap .5)", dict(batch_size=2)),
    ("batch-4 (dcn, cap .5)", dict(batch_size=4)),
    ("batch-4 cap off", dict(batch_size=4, cam_capacity=1.0)),
)


def measure(tag, filters=(), H=640, W=1600, N=6, device="cuda",
            iters=ITERS, **kw):
    """One row: {'feats_ms', 'full_ms', 'decode_ms', 'cam_overflow'}, or
    None where `filters` name none of the tag."""
    if filters and not any(f in tag for f in filters):
        return None
    cfg, model, images, l2i = build(H, W, N, device=device, **kw)
    feats, full, full_decode = stage_fns(cfg, model, images, l2i)
    with torch.no_grad():
        overflow = float(full()["cam_overflow"])
        row = {"feats_ms": timed_ms(feats, images.device, iters),
               "full_ms": timed_ms(full, images.device, iters),
               "decode_ms": timed_ms(full_decode, images.device, iters),
               "cam_overflow": overflow}
    print(f"{tag:28s} feats {row['feats_ms']:6.1f} ms | full "
          f"{row['full_ms']:6.1f} ms (head ~{row['full_ms'] - row['feats_ms']:5.1f})"
          f" | +decode {row['decode_ms']:6.1f} ms | cam_overflow {overflow:g}",
          flush=True)
    return row


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="graph_detr4d_tpu_torch.tools.profile_breakdown")
    p.add_argument("filters", nargs="*",
                   help="keep the rows whose tag holds one of these")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    from ..utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    print("device:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else device, flush=True)
    rows = {}
    for tag, kw in ABLATIONS:
        row = measure(tag, args.filters, device=device, **kw)
        if row is not None:
            rows[tag] = row
    return rows


if __name__ == "__main__":
    main()
