"""FLOP count of the port's forward (counterpart of tools/get_flops.py,
which reads XLA's cost analysis; reference
tools/analysis_tools/get_flops.py, mmcv's hook-based counter).

    python -m graph_detr4d_tpu_torch.tools.get_flops \\
        [--img-h 640 --img-w 1600 --cams 6] [--tiny] [--device cuda]

The JAX tool's flags and model: the default ModelConfig with `--cams`
cameras at `--img-h` x `--img-w` (fp32), or the tiny test config, seeded
random weights, one synthetic sample. `torch.utils.flop_counter.
FlopCounterMode` counts the convolutions and matrix products PyTorch
runs. K1 (MSDA), K2 (DCNv2) and K3 (its int8-table form) count by their
own operation formulas, the ones chip_smoke.py's bounds use, whichever
route runs them: on the card a kernel is a ctypes call the counter cannot
see, and on the CPU its plain version's products are left out:
  K1: 2 x head_dim FLOPs per bilinear corner inside the image whose
      weight (corner weight x attention weight) is nonzero;
  K2, K3: 2 x M x 9 Cin x Cout, M the output pixels.
Elementwise work is not counted, so the total is below XLA's.
"""

import argparse
import contextlib

import torch
from torch.utils.flop_counter import FlopCounterMode


def msda_operations(value, spatial_shapes, loc, attn, index=None) -> int:
    """K1's operation count for one call: 2 x head_dim per in-image
    bilinear corner of a sample whose corner weight and attention weight
    are both nonzero (the forward skips the rest). value (BN, S, heads,
    hd); loc (BN, Q, heads, L, P, 2); attn (BN, Q, heads, L, P); index
    (BN, R) or None."""
    hd = value.shape[-1]
    if index is not None:
        rows = torch.arange(loc.shape[0], device=loc.device)[:, None]
        loc, attn = loc[rows, index], attn[rows, index]
    corners = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        x = loc[..., lvl, :, 0].float() * W - 0.5
        y = loc[..., lvl, :, 1].float() * H - 0.5
        live = attn[..., lvl, :] != 0
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        for dy, wy in ((0, 1.0 - fy), (1, fy)):
            for dx, wx in ((0, 1.0 - fx), (1, fx)):
                xx, yy = x0 + dx, y0 + dy
                inside = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
                corners += int((inside & live & (wx * wy != 0)).sum())
    return 2 * hd * corners


def dcn_operations(x, offsets, weight) -> int:
    """K2's (and K3's) operation count for one call: 2 x M x 9 Cin x Cout,
    x (B, H, W, Cin), offsets (B, Ho, Wo, 9, 2), weight (Cout, Cin, 3,
    3)."""
    B, Ho, Wo = offsets.shape[:3]
    cout, cin = weight.shape[:2]
    return 2 * B * Ho * Wo * 9 * cin * cout


@contextlib.contextmanager
def kernel_formulas(counter: FlopCounterMode):
    """Route every K1 / K2 / K3 call through a wrapper that adds its
    formula's count to `kernels` and the products the counter saw inside
    the call (the CPU's plain version) to `inside`, so that they can be
    taken out of the counter's total."""
    from ..models import resnet as resnet_mod
    from ..ops import deform_conv as dcn_ops
    from ..ops import msda as msda_ops

    tally = {"kernels": {"msda_forward": 0, "deform_conv_forward": 0,
                         "deform_conv_int8_forward": 0},
             "calls": {"msda_forward": 0, "deform_conv_forward": 0,
                       "deform_conv_int8_forward": 0},
             "inside": 0}

    def counted(name, fn, ops):
        def wrapper(*args, **kwargs):
            before = counter.get_total_flops()
            out = fn(*args, **kwargs)
            tally["inside"] += counter.get_total_flops() - before
            key = name(*args, **kwargs)
            tally["kernels"][key] += ops(*args, **kwargs)
            tally["calls"][key] += 1
            return out
        return wrapper

    def dcn_name(x, offsets, mask, weight, stride=1, padding=1,
                 variant="shift4"):
        H, W = x.shape[1:3]
        return ("deform_conv_int8_forward"
                if dcn_ops.select_variant(H, W, variant) == "int8"
                else "deform_conv_forward")

    real_msda, real_dcn = msda_ops.msda_forward, resnet_mod.deform_conv2d
    msda_ops.msda_forward = counted(
        lambda *a, **k: "msda_forward", real_msda,
        lambda value, shapes, loc, attn, index=None: msda_operations(
            value, shapes, loc, attn, index))
    resnet_mod.deform_conv2d = counted(
        dcn_name, real_dcn,
        lambda x, offsets, mask, weight, *a, **k: dcn_operations(
            x, offsets, weight))
    try:
        yield tally
    finally:
        msda_ops.msda_forward, resnet_mod.deform_conv2d = real_msda, real_dcn


def count_forward(model, images, lidar2img, **extras) -> dict:
    """One eval forward of `model` under FlopCounterMode with the kernel
    formulas: {'total', 'matmul_conv' (what PyTorch ran outside the
    kernels), 'kernels' (each kernel's formula summed), 'kernel_calls',
    'by_op' (the counter's own count per aten op, the kernels' plain
    versions included)}."""
    counter = FlopCounterMode(display=False)
    # no parameter requires a gradient while counting: the counter's module
    # tracker hooks every tensor that does, and a no_grad view of one has
    # no grad_fn to hook
    grads = [(p, p.requires_grad) for p in model.parameters()]
    for p, _ in grads:
        p.requires_grad_(False)
    try:
        with torch.no_grad(), counter, kernel_formulas(counter) as tally:
            model(images, lidar2img, **extras)
    finally:
        for p, req in grads:
            p.requires_grad_(req)
    counted = counter.get_total_flops()
    matmul_conv = counted - tally["inside"]
    by_op = {str(op): int(n) for op, n in
             counter.get_flop_counts().get("Global", {}).items()}
    return {"total": matmul_conv + sum(tally["kernels"].values()),
            "matmul_conv": matmul_conv, "kernels": dict(tally["kernels"]),
            "kernel_calls": dict(tally["calls"]), "by_op": by_op}


def build_config(args):
    """The JAX tool's configs: tiny_test_config, or the default
    ModelConfig with --cams cameras at --img-h x --img-w, fp32."""
    from ..config import HeadConfig, ModelConfig, tiny_test_config

    if args.tiny:
        return tiny_test_config()
    return ModelConfig(head=HeadConfig(num_cams=args.cams, with_detach=False),
                       img_size=(args.img_h, args.img_w), bf16=False)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="graph_detr4d_tpu_torch.tools.get_flops")
    p.add_argument("--img-h", type=int, default=640)
    p.add_argument("--img-w", type=int, default=1600)
    p.add_argument("--cams", type=int, default=6)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    from ..data.synthetic import synthetic_batch
    from ..models.detector import GraphDETR4D
    from ..utils.device import resolve_device
    from ..weights import init_weights

    args = parse_args(argv)
    cfg = build_config(args)
    device = resolve_device(args.device)
    model = GraphDETR4D(cfg, device="cpu")
    init_weights(model, 0)
    model = model.to(device).eval()
    b = synthetic_batch(cfg, 1)
    images = torch.as_tensor(b["images"], device=device)
    l2i = torch.as_tensor(b["lidar2img"], device=device)
    out = count_forward(model, images, l2i)
    params = sum(p.numel() for p in model.parameters())
    h, w = cfg.img_size
    out.update(params=params, cams=cfg.head.num_cams, img_hw=[h, w])
    print(f"input: {cfg.head.num_cams} cams x {h}x{w}")
    print(f"params: {params / 1e6:.2f} M")
    print(f"flops:  {out['total'] / 1e9:.2f} GFLOPs (matmul and conv "
          f"{out['matmul_conv'] / 1e9:.2f}, kernels "
          + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in out["kernels"].items())
          + ")")
    return out


if __name__ == "__main__":
    main()
