#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check every kernel.

    python3 chip_smoke.py

Runs the flagship Graph-DETR4D config
(detr4d_res50_deform_pe_testaug_2subset_12e: 12 cameras at 640x1600,
ResNet-50 + DCNv2, 900 queries, 6 decoder layers, bf16) with seeded random
weights, serving and training, and prints one JSON line per phase:

  1. build    nvcc for every kernel source, all started together;
  2. kernels  each kernel against its plain PyTorch version at the main
              path's shapes, fp32 (TF32 off, max abs error <= 1e-4) and
              bf16 (error <= 2e-2 of the output's max magnitude), with
              samples outside the image and both DCN strides; kernel time,
              plain time and the bound (least time for the bytes moved or
              the operations done). The backward kernels of K1 / K2 are
              held to torch.autograd.grad of the plain versions (fp32: 1e-4
              of the gradient's magnitude where that exceeds 1, since the
              location gradients carry a factor W from the sampling
              position; position gradients of samples within 1e-4 px of
              an integer coordinate, where the bilinear derivative jumps,
              are left out and counted); K5 (focal loss) within 1e-5
              relative; K4
              (assignment) identical, on random costs, planted ties and
              nan / inf entries, num_valid from 0 to 128;
  3. serve    serve.Engine answers 4 requests from synthetic_batch; time
              per request (CUDA events), peak memory, cam_overflow, valid
              detections and the launch counters (K1 6 and K2 9 per
              request), counted from 0 just before the requests;
              then one more request split into stages by CUDA events, and
              a torch.profiler trace of one: device busy share, top
              kernels (phase "breakdown");
  4. plain    the same weights in fp32, once through the kernels and once
              through their plain versions (launch counts 6 / 9, then
              0 / 0): logits and boxes of decoder layers 0-1 agree within
              1e-4, of every layer within 1e-3;
  5. train    train.Trainer at full width (batch 1, 40 GT boxes, grid mask
              and dropout on): 1 warm-up step, then 5 timed steps (CUDA
              events), loss and grad_norm per step, peak memory, and the
              launch counts per step (K1 fwd 6 / bwd 6, K2 fwd 9 / bwd 9,
              K5 1, K4 1); the frozen stem stays bit-identical and a
              main-group weight moves; then one step split into stages and
              a torch.profiler trace of one (phase "train_breakdown");
  6. train_plain  one fp32 step (dropout 0, grid mask off) through the
              kernels and one through the plain versions from the same
              weights: launches (6, 6, 9, 9, 1, 1) then all 0, loss and
              per-layer losses within 1e-5 relative, grad_norm within 5e-4,
              and every layer's assignment identical (or, where rounding of
              the two routes' costs picks another optimum, the same summed
              cost within 1e-5).

Then the card's name and power limit as nvidia-smi gives them, the kernel
table as one JSON line, and last `{"ok": true, "device": {...}}`. Any
failed phase raises: the script exits non-zero and prints no result. It
needs one CUDA device and the CUDA toolkit, and imports no JAX.
"""

import contextlib
import dataclasses
import itertools
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from graph_detr4d_tpu_torch.configs import get_config
from graph_detr4d_tpu_torch.core.coder import decode_batch
from graph_detr4d_tpu_torch.data.synthetic import synthetic_batch
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D
from graph_detr4d_tpu_torch.ops import build
from graph_detr4d_tpu_torch.core.losses import detr3d_loss
from graph_detr4d_tpu_torch.ops import deform_conv as dcn_ops
from graph_detr4d_tpu_torch.ops import focal_loss as focal_ops
from graph_detr4d_tpu_torch.ops import hungarian as lsa_ops
from graph_detr4d_tpu_torch.ops import msda as msda_ops
from graph_detr4d_tpu_torch.serve import Engine
from graph_detr4d_tpu_torch.train.optim import clip_by_global_norm
from graph_detr4d_tpu_torch.train.step import TrainStep
from graph_detr4d_tpu_torch.train.trainer import Trainer
from graph_detr4d_tpu_torch.weights import init_weights

CONFIG = "detr4d_res50_deform_pe_testaug_2subset_12e"
REQUESTS = 4
MSDA_CALLS, DCN_CALLS = 6, 9  # per request: decoder layers, DCN convs
TRAIN_STEPS, NUM_GT = 5, 40
# fp32 train step, kernels vs plain: losses and grad_norm, relative.
# First set at 1e-4 / 1e-3, tightened after runs measured at most 3.4e-7
# and 4.8e-5 (NVIDIA H100 80GB HBM3, 700 W; see PERF.md)
TRAIN_PLAIN_RTOL, TRAIN_PLAIN_GRAD_NORM_RTOL = 1e-5, 5e-4
# launches per train step: K1 fwd / bwd, K2 fwd / bwd, K5, K4
STEP_LAUNCHES = {"msda_forward": 6, "msda_backward": 6, "deform_im2col": 9,
                 "deform_col2im": 9, "focal_loss": 1, "hungarian": 1}
# fp32 kernel path vs plain path: decoder layers 0-1, and every layer
PLAIN_EARLY_ATOL, PLAIN_ATOL = 1e-4, 1e-3
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# the DCN convs of one request at 640x1600 x 12 cameras: (H, W, Cin,
# stride) of the input, and how many of the 9 have that shape
DCN_SHAPES = [((80, 200, 256, 2), 1), ((40, 100, 256, 1), 5),
              ((40, 100, 512, 2), 1), ((20, 50, 512, 1), 2)]
MSDA_LEVELS = [(80, 200), (40, 100), (20, 50), (10, 25)]


def emit(record):
    print(json.dumps(record), flush=True)


def cuda_ms(fn, iters):
    """Mean device time of fn over iters launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def launch_counts():
    return {"msda_forward": msda_ops.launches,
            "msda_backward": msda_ops.backward_launches,
            "deform_im2col": dcn_ops.launches,
            "deform_col2im": dcn_ops.backward_launches,
            "focal_loss": focal_ops.launches,
            "hungarian": lsa_ops.launches}


def reset_launch_counts():
    msda_ops.launches = msda_ops.backward_launches = 0
    dcn_ops.launches = dcn_ops.backward_launches = 0
    focal_ops.launches = lsa_ops.launches = 0


def check_grads_close(name, got, want, dtype, skip=None):
    """Gradients: fp32 within 1e-4 of max(1, magnitude), bf16 within 2e-2
    of the magnitude. skip: {tensor position: boolean mask, broadcast to
    it, of elements left out}. Returns (worst abs error, its tensor's
    magnitude)."""
    worst = (0.0, 0.0)
    for i, (g, w) in enumerate(zip(got, want)):
        diff = (g.float() - w.float()).abs()
        if skip and i in skip:
            diff = diff.masked_fill(skip[i], 0.0)
        err = diff.max().item()
        scale = w.float().abs().max().item()
        if not np.isfinite(err):
            raise AssertionError(f"{name}[{i}]: non-finite gradient")
        tol = 1e-4 * max(1.0, scale) if dtype == torch.float32 else 2e-2 * scale
        if err > tol:
            raise AssertionError(f"{name}[{i}]: {dtype} max abs error {err} > "
                                 f"{tol} (magnitude {scale})")
        worst = max(worst, (err, scale))
    return worst


def dev_us(e):
    return getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0.0)


def device_events(prof):
    """The profile's device-side entries (kernels, memcpy, memset) with
    device time: an operator's CPU entry, and a user annotation such as
    `Optimizer.step#AdamW.step`, repeat the device time of the kernels
    they launched."""
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0
            and not getattr(e, "is_user_annotation", False)]


def check_close(name, got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if not np.isfinite(err):
        raise AssertionError(f"{name}: non-finite output")
    if dtype == torch.float32 and err > 1e-4:
        raise AssertionError(f"{name}: fp32 max abs error {err} > 1e-4")
    if dtype == torch.bfloat16 and err > 2e-2 * scale:
        raise AssertionError(
            f"{name}: bf16 max abs error {err} > 2e-2 * {scale}")
    return err, scale


def bilinear_corners(x, y, H, W):
    """Integer corners and bilinear weights (zero outside) of samples at
    pixel coordinates (x, y), as both kernels compute them."""
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        xx, yy = x0 + dx, y0 + dy
        w = (fy if dy else 1 - fy) * (fx if dx else 1 - fx)
        inb = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        yield xx, yy, w * inb


KINK = 1e-4  # pixels: 8x the fp32 rounding of a position near 200


def near_kink(py, px):
    """Samples within KINK of an integer pixel coordinate (float64
    positions). The bilinear sample's derivative along a coordinate jumps
    where that coordinate crosses an integer, so there the gradient for
    the position is a choice between two one-sided values, and the
    kernel's fp32 position and the plain version's float64 one may land on
    either side. Their position gradients are left out of the comparison;
    every other gradient is continuous there."""
    return ((py - py.round()).abs() < KINK) | ((px - px.round()).abs() < KINK)


def msda_kinks(loc, levels):
    """near_kink of every K1 sample: (BN, Q, heads, L, P, 1)."""
    H = torch.tensor([h for h, _ in levels], dtype=torch.float64,
                     device=loc.device).view(1, 1, 1, -1, 1)
    W = torch.tensor([w for _, w in levels], dtype=torch.float64,
                     device=loc.device).view(1, 1, 1, -1, 1)
    return near_kink(loc[..., 1].double() * H - 0.5,
                     loc[..., 0].double() * W - 0.5)[..., None]


def dcn_kinks(offsets, stride):
    """near_kink of every K2 tap sample: (B, Ho, Wo, 9, 1)."""
    _, Ho, Wo = offsets.shape[:3]
    dev = offsets.device
    k = torch.arange(9, device=dev)
    py = ((torch.arange(Ho, device=dev) * stride - 1)[None, :, None, None]
          + k // 3 + offsets[..., 0].double())
    px = ((torch.arange(Wo, device=dev) * stride - 1)[None, None, :, None]
          + k % 3 + offsets[..., 1].double())
    return near_kink(py, px)[..., None]


def touched_value_rows(value, loc, attn, index, need_attn):
    """(distinct value rows, corner count) that K1's samples of the
    selected queries read: in-image corners, and with need_attn only those
    whose attention weight is nonzero (the forward skips the rest; the
    backward needs every in-image sample for grad_attn)."""
    BN, S, heads, hd = value.shape
    rows = torch.arange(BN, device=value.device)[:, None]
    loc, attn = loc[rows, index], attn[rows, index]
    R, P = loc.shape[1], loc.shape[4]
    bn = rows[:, :, None, None].expand(BN, R, heads, P)
    h = torch.arange(heads, device=value.device)[None, None, :, None]
    touched, nnz, start = [], 0, 0
    for lvl, (H, W) in enumerate(MSDA_LEVELS):
        x = loc[:, :, :, lvl, :, 0] * W - 0.5
        y = loc[:, :, :, lvl, :, 1] * H - 0.5
        a = attn[:, :, :, lvl]
        for xx, yy, w in bilinear_corners(x, y, H, W):
            keep = (w * a) != 0 if need_attn else w != 0
            pix = start + yy[keep].long() * W + xx[keep].long()
            touched.append((bn[keep] * S + pix) * heads + h.expand_as(keep)[keep])
            nnz += int(keep.sum())
        start += H * W
    return torch.unique(torch.cat(touched)).numel(), nnz


def msda_bound_ms(value, loc, attn, index):
    """Least time for one K1 call on these inputs: the value rows its
    nonzero corner weights touch (each read once), the selected queries'
    loc / attn, the index and the output, over HBM bandwidth; or its FMAs
    over the fp32 rate."""
    BN, S, heads, hd = value.shape
    rows_read, nnz = touched_value_rows(value, loc, attn, index, True)
    R = index.shape[1]
    per_query = attn[0, 0].numel()  # heads * L * P samples of one query
    elt = value.element_size()
    bytes_ = (rows_read * hd * elt + BN * R * per_query * (2 * 4 + 4)
              + index.numel() * 8 + BN * R * heads * hd * elt)
    flops = 2 * hd * nnz
    t_bytes, t_ops = bytes_ / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def msda_backward_bound_ms(value, loc, attn, index):
    """Least time for one K1 backward call: the value rows its in-image
    corners touch and the selected queries' loc / attn, the index and
    grad_out read once; grad_value (dense, value's dtype), grad_loc and
    grad_attn (dense, fp32) written once; or about 8 FLOPs per in-image
    corner and channel (sample, two position derivatives, the scatter)
    over the fp32 rate."""
    BN, S, heads, hd = value.shape
    rows_read, corners = touched_value_rows(value, loc, attn, index, False)
    R = index.shape[1]
    per_query = attn[0, 0].numel()  # heads * L * P samples of one query
    elt = value.element_size()
    bytes_ = (rows_read * hd * elt + BN * R * per_query * (2 * 4 + 4)
              + index.numel() * 8
              + BN * R * heads * hd * elt + value.numel() * elt
              + loc.numel() * 4 + attn.numel() * 4)
    t_bytes = bytes_ / PEAK_BYTES_PER_S
    t_ops = 8 * hd * corners / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def dcn_in_image_corners(x, offsets, stride):
    B, H, W, C = x.shape
    _, Ho, Wo = offsets.shape[:3]
    ys = torch.arange(Ho, device=x.device)[:, None] * stride - 1
    xs = torch.arange(Wo, device=x.device)[None, :] * stride - 1
    corners = 0
    for k in range(9):
        py = ys + k // 3 + offsets[..., k, 0].float()
        px = xs + k % 3 + offsets[..., k, 1].float()
        corners += sum(int((w != 0).sum())
                       for _, _, w in bilinear_corners(px, py, H, W))
    return corners


def dcn_backward_bound_ms(x, offsets, stride):
    """Least time for one K2 backward call: x, offsets, mask and grad_cols
    read once, grad_x, grad_offsets and grad_mask written once (x's
    dtype); or about 8 FLOPs per in-image corner and channel over the
    fp32 rate."""
    B, H, W, C = x.shape
    npix = B * offsets.shape[1] * offsets.shape[2]
    elt = x.element_size()
    bytes_ = 2 * (x.numel() + npix * 27) * elt + npix * 9 * C * elt
    t_bytes = bytes_ / PEAK_BYTES_PER_S
    t_ops = 8 * C * dcn_in_image_corners(x, offsets, stride) / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def dcn_bound_ms(x, offsets, stride):
    """Least time for one K2 call: x, offsets and mask read once and the
    column tile written once, over HBM bandwidth; or 2 FLOPs per in-image
    corner and channel over the fp32 rate."""
    B, H, W, C = x.shape
    _, Ho, Wo = offsets.shape[:3]
    elt = x.element_size()
    npix = B * Ho * Wo
    bytes_ = (x.numel() + npix * 27 + npix * 9 * C) * elt
    t_bytes = bytes_ / PEAK_BYTES_PER_S
    t_ops = 2 * dcn_in_image_corners(x, offsets, stride) * C / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_build():
    t0 = time.perf_counter()
    nvcc = build.build()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": nvcc, "card": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_kernels(dev):
    gen = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def rand(*shape):
        return torch.rand(*shape, generator=gen).to(dev)

    results = {}
    # K1 at the main path's call: 12 cameras, 900 queries of which each
    # camera keeps 450 (cam_capacity 0.5), 8 heads x 32, 4 levels x 4 points
    BN, Q, R, heads, hd, L, P = 12, 900, 450, 8, 32, 4, 4
    S = sum(h * w for h, w in MSDA_LEVELS)
    value32 = randn(BN, S, heads, hd)
    loc = (rand(BN, Q, heads, L, P, 2) * 1.2 - 0.1).contiguous()  # some outside
    attn = torch.softmax(randn(BN, Q, heads, L * P), -1).view(BN, Q, heads, L, P)
    attn = (attn * (rand(BN, Q, heads, L, P) > 0.5)).contiguous()  # masked
    index = torch.stack([torch.randperm(Q, generator=gen)[:R]
                         for _ in range(BN)]).to(dev)
    checks = {}
    for dtype in (torch.float32, torch.bfloat16):
        value = value32.to(dtype)
        for name, idx in (("index", index), ("all", None)):
            got = msda_ops.msda_forward(value, MSDA_LEVELS, loc, attn, idx)
            want = msda_ops.msda_forward_plain(value, MSDA_LEVELS, loc, attn, idx)
            checks[f"{name}_{str(dtype)[6:]}"] = check_close(
                f"msda {name} {dtype}", got, want, dtype)
    value = value32.to(torch.bfloat16)
    ms = cuda_ms(lambda: msda_ops.msda_forward(value, MSDA_LEVELS, loc, attn,
                                               index), 20)
    plain_ms = cuda_ms(lambda: msda_ops.msda_forward_plain(
        value, MSDA_LEVELS, loc, attn, index), 3)
    bound, bound_by = msda_bound_ms(value, loc, attn, index)
    results["msda_forward"] = dict(
        checks=checks, ms=ms * MSDA_CALLS, plain_ms=plain_ms * MSDA_CALLS,
        bound_ms=bound * MSDA_CALLS, bound_by=bound_by, per_call_ms=ms)
    emit({"phase": "kernels", "kernel": "msda_forward",
          "shape": [BN, Q, R, heads, hd, L, P], **results["msda_forward"]})

    # K1 backward: the same inputs, grad_out of the output's shape
    kinks = msda_kinks(loc, MSDA_LEVELS)
    checks = {"samples_near_kink": int(kinks.sum())}
    for dtype in (torch.float32, torch.bfloat16):
        value = value32.to(dtype)
        for name, idx in (("index", index), ("all", None)):
            g = randn(BN, R if idx is not None else Q, heads * hd).to(dtype)
            got = msda_ops.msda_backward(value, MSDA_LEVELS, loc, attn, g, idx)
            want = msda_ops.msda_backward_plain(value, MSDA_LEVELS, loc, attn,
                                                g, idx)
            checks[f"{name}_{str(dtype)[6:]}"] = check_grads_close(
                f"msda_backward {name} {dtype}", got, want, dtype,
                skip={1: kinks})
            del got, want
    value = value32.to(torch.bfloat16)
    g = randn(BN, R, heads * hd).to(torch.bfloat16)
    ms = cuda_ms(lambda: msda_ops.msda_backward(value, MSDA_LEVELS, loc, attn,
                                                g, index), 20)
    plain_ms = cuda_ms(lambda: msda_ops.msda_backward_plain(
        value, MSDA_LEVELS, loc, attn, g, index), 3)
    bound, bound_by = msda_backward_bound_ms(value, loc, attn, index)
    results["msda_backward"] = dict(
        checks=checks, ms=ms * MSDA_CALLS, plain_ms=plain_ms * MSDA_CALLS,
        bound_ms=bound * MSDA_CALLS, bound_by=bound_by, per_call_ms=ms)
    emit({"phase": "kernels", "kernel": "msda_backward",
          "shape": [BN, Q, R, heads, hd, L, P], **results["msda_backward"]})
    del value32, value, g

    # K2 forward and backward at the 4 DCN shapes of one request, both
    # strides
    fwd = {"checks": {}, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "by": set()}
    bwd = {"checks": {}, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "by": set()}
    for (H, W, C, stride), count in DCN_SHAPES:
        Ho, Wo = dcn_ops.output_size(H, stride, 1), dcn_ops.output_size(W, stride, 1)
        x32 = randn(12, H, W, C)
        off32 = randn(12, Ho, Wo, 9, 2) * 3.0  # some taps land outside
        mask32 = rand(12, Ho, Wo, 9)
        g32 = randn(12 * Ho * Wo, 9 * C)
        tag = f"{H}x{W}x{C}_s{stride}"
        for dtype in (torch.float32, torch.bfloat16):
            x, off, mask, g = (t.to(dtype) for t in (x32, off32, mask32, g32))
            kinks = dcn_kinks(off, stride)
            bwd["checks"][f"{tag}_{str(dtype)[6:]}_near_kink"] = int(kinks.sum())
            got = dcn_ops.deform_im2col(x, off, mask, stride)
            want = dcn_ops.deform_im2col_plain(x, off, mask, stride)
            fwd["checks"][f"{tag}_{str(dtype)[6:]}"] = check_close(
                f"deform_im2col {tag} {dtype}", got, want, dtype)
            del got, want
            got = dcn_ops.deform_col2im(x, off, mask, g, stride)
            want = dcn_ops.deform_col2im_plain(x, off, mask, g, stride)
            bwd["checks"][f"{tag}_{str(dtype)[6:]}"] = check_grads_close(
                f"deform_col2im {tag} {dtype}", got, want, dtype,
                skip={1: kinks})
            del got, want
        x, off, mask, g = (t.to(torch.bfloat16) for t in (x32, off32, mask32, g32))
        for rec, fn, plain, bound_fn in (
            (fwd, lambda: dcn_ops.deform_im2col(x, off, mask, stride),
             lambda: dcn_ops.deform_im2col_plain(x, off, mask, stride),
             dcn_bound_ms),
            (bwd, lambda: dcn_ops.deform_col2im(x, off, mask, g, stride),
             lambda: dcn_ops.deform_col2im_plain(x, off, mask, g, stride),
             dcn_backward_bound_ms),
        ):
            rec["ms"] += count * cuda_ms(fn, 20)
            rec["plain_ms"] += count * cuda_ms(plain, 3)
            b, b_by = bound_fn(x, off, stride)
            rec["bound_ms"] += count * b
            rec["by"].add(b_by)
        del x32, off32, mask32, g32, x, off, mask, g
        torch.cuda.empty_cache()
    for name, rec in (("deform_im2col", fwd), ("deform_col2im", bwd)):
        by = rec.pop("by")
        results[name] = dict(rec, bound_by="bytes" if by == {"bytes"}
                             else "operations")
        emit({"phase": "kernels", "kernel": name, "shapes": DCN_SHAPES,
              **results[name]})

    results["focal_loss"] = kernel_focal_loss(dev, gen)
    results["hungarian"] = kernel_hungarian(dev, gen)
    return results


def kernel_focal_loss(dev, gen):
    """K5 at the flagship's loss: 6 decoder layers x 900 queries x 10
    classes, labels with background, per-layer avg_factor."""
    layers, N, C = 6, 900, 10
    logits = (torch.randn(layers, N, C, generator=gen) * 3).to(dev)
    labels = torch.randint(0, C + 1, (layers, N), generator=gen).to(dev)
    weights = torch.rand(layers, N, generator=gen).to(dev)
    avg = (torch.rand(layers, generator=gen) * 40 + 1).to(dev)
    loss, grad = focal_ops.focal_loss_with_grad(logits, labels, weights, avg)
    leaf = logits.clone().requires_grad_()
    want = focal_ops.sigmoid_focal_loss_plain(leaf, labels, weights, avg)
    (want_grad,) = torch.autograd.grad(want.sum(), leaf)
    loss_err = ((loss - want).abs() / want.abs()).max().item()
    grad_err = (grad - want_grad).abs().max().item()
    grad_scale = want_grad.abs().max().item()
    if not (loss_err <= 1e-5 and grad_err <= 1e-5 * grad_scale):
        raise AssertionError(f"focal_loss: loss rel {loss_err}, grad {grad_err}"
                             f" of {grad_scale}")
    ms = cuda_ms(lambda: focal_ops.focal_loss_with_grad(logits, labels,
                                                        weights, avg), 50)

    def plain():
        leaf = logits.clone().requires_grad_()
        out = focal_ops.sigmoid_focal_loss_plain(leaf, labels, weights, avg)
        torch.autograd.grad(out.sum(), leaf)

    plain_ms = cuda_ms(plain, 20)
    n = logits.numel()
    # read logits, labels, weights, avg; write the loss and dlogits
    bytes_ = n * 4 + labels.numel() * 8 + weights.numel() * 4 + layers * 8 + n * 4
    t_bytes = bytes_ / PEAK_BYTES_PER_S
    t_ops = 40 * n / PEAK_FP32_FLOPS  # exp, log1p, pow, ~40 flops each
    record = dict(checks={"loss_rel": loss_err, "grad_abs": grad_err,
                          "grad_scale": grad_scale},
                  max_abs_err=max((loss - want).abs().max().item(), grad_err),
                  ms=ms, plain_ms=plain_ms, bound_ms=1e3 * max(t_bytes, t_ops),
                  bound_by="bytes" if t_bytes >= t_ops else "operations")
    emit({"phase": "kernels", "kernel": "focal_loss",
          "shape": [layers, N, C], **record})
    return record


def kernel_hungarian(dev, gen):
    """K4 at the flagship's matching: 6 problems (layers) of 128 GT rows x
    900 queries, identical to the plain version on random costs with
    num_valid from 0 to 128, on planted ties and on nan / inf entries."""
    P, R, C = 6, 128, 900
    nv = torch.tensor([0, 1, 40, 64, 127, 128], dtype=torch.int32)
    base = torch.rand(P, R, C, generator=gen)
    cases = {
        "random": base,
        "ties": torch.round(base * 4) / 4,
        "nan_inf": base.clone().index_put_(
            (torch.arange(P), torch.arange(P), torch.arange(P) * 7),
            torch.tensor([float("nan"), float("inf"), float("-inf")] * 2)),
    }
    mismatches, steps = {}, None
    for name, cost in cases.items():
        cost_d, nv_d = cost.to(dev), nv.to(dev)
        got = lsa_ops.hungarian_assignment(cost_d, nv_d)
        want, k = lsa_ops.hungarian_assignment_plain(cost_d, nv_d,
                                                     return_steps=True)
        mismatches[name] = int((got != want).sum())
        if name == "random":
            steps = k
    if any(mismatches.values()):
        raise AssertionError(f"hungarian: assignments differ {mismatches}")
    cost_d, nv_d = base.to(dev), nv.to(dev)
    ms = cuda_ms(lambda: lsa_ops.hungarian_assignment(cost_d, nv_d), 20)
    t0 = time.perf_counter()
    lsa_ops.hungarian_assignment_plain(cost_d, nv_d)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    # the work depends on the data: each Dijkstra step reads one cost row
    bytes_ = sum(steps) * C * 4 + P * 4 + P * R * 4
    t_bytes = bytes_ / PEAK_BYTES_PER_S
    t_ops = sum(steps) * C * 4 / PEAK_FP32_FLOPS  # 3 adds and a compare
    record = dict(checks={"mismatches": mismatches, "dijkstra_steps": steps},
                  max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                  bound_ms=1e3 * max(t_bytes, t_ops),
                  bound_by="bytes" if t_bytes >= t_ops else "operations",
                  note="latency-bound: the steps of a problem are sequential")
    emit({"phase": "kernels", "kernel": "hungarian", "shape": [P, R, C],
          "num_valid": nv.tolist(), **record})
    return record


def random_state_dict(cfg):
    """Seeded random weights (weights.init_weights: zero-initialised
    projections perturbed, reg-branch output layers scaled down)."""
    model = GraphDETR4D(cfg, device="cpu")
    init_weights(model, seed=0)
    return model.state_dict()


def phase_serve(cfg, sd):
    batch = synthetic_batch(cfg, seed=0)
    engine = Engine(cfg, sd)  # warms up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, results = [], []
    for _ in range(REQUESTS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        r = engine.infer(batch["images"], batch["lidar2img"])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        results.append(r)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    r = results[-1]
    record = {
        "phase": "serve", "config": CONFIG, "requests": REQUESTS,
        "ms_per_request": times, "mean_ms": sum(times) / len(times),
        "peak_memory_bytes": peak, "cam_overflow": r["cam_overflow"],
        "valid_detections": int(r["valid"].sum()), "launches": launches,
    }
    emit(record)
    want = dict.fromkeys(launches, 0)
    want.update(msda_forward=MSDA_CALLS * REQUESTS,
                deform_im2col=DCN_CALLS * REQUESTS)
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if r["bboxes"].shape != (1, cfg.coder.max_num, 9):
        raise AssertionError(f"bboxes shape {r['bboxes'].shape}")
    for k in ("bboxes", "scores"):
        if not np.isfinite(r[k]).all():
            raise AssertionError(f"non-finite {k}")
    if not all(np.array_equal(x["labels"], r["labels"]) for x in results):
        raise AssertionError("repeated requests disagree")
    return engine, batch, launches


def phase_breakdown(engine, batch):
    """Where one request's time goes: its stages between CUDA events, and
    a torch.profiler trace of one request (device busy share of the
    request's span, top kernels by device time)."""
    model, c, dev = engine.model, engine.cfg.coder, engine.device
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    with torch.inference_mode():
        ev[0].record()
        images = torch.as_tensor(batch["images"]).to(dev)
        l2i = torch.as_tensor(batch["lidar2img"]).to(dev)
        ev[1].record()
        feats = model.extract_feats(images)
        ev[2].record()
        out = model.forward_feats(feats, l2i)
        ev[3].record()
        det = decode_batch(out, max_num=c.max_num,
                           post_center_range=c.post_center_range)
        _ = [v.cpu() for v in det]  # D2H of the detections
        ev[4].record()
        ev[4].synchronize()
    names = ("h2d", "backbone_neck", "head", "decode_d2h")
    stages = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        engine.infer(batch["images"], batch["lidar2img"])
        end.record()
        end.synchronize()
    span_ms = start.elapsed_time(end)
    events = device_events(prof)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:12]
    emit({"phase": "breakdown", "stages_ms": stages,
          "profiled_request_ms": span_ms, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / span_ms,
          "top_device_ms": [[e.key[:60], dev_us(e) / 1e3, e.count]
                            for e in top]})
    if busy_ms > span_ms:  # device time counted twice somewhere
        raise AssertionError(
            f"device busy {busy_ms} ms exceeds the request's {span_ms} ms")


KERNEL_ROUTES = ((msda_ops, "msda_forward", "msda_forward_plain"),
                 (dcn_ops, "deform_im2col", "deform_im2col_plain"),
                 (focal_ops, "sigmoid_focal_loss", "sigmoid_focal_loss_plain"),
                 (lsa_ops, "hungarian_assignment",
                  "hungarian_assignment_plain"))


@contextlib.contextmanager
def plain_kernels():
    """Route the model's and the loss's kernel calls to the plain versions
    (autograd differentiates those, so no backward kernel runs either)."""
    saved = [getattr(m, k) for m, k, _ in KERNEL_ROUTES]
    for m, k, plain in KERNEL_ROUTES:
        setattr(m, k, getattr(m, plain))
    try:
        yield
    finally:
        for (m, k, _), fn in zip(KERNEL_ROUTES, saved):
            setattr(m, k, fn)


@contextlib.contextmanager
def record_assignments(calls):
    """Append (cost, num_valid, col4row) of every K4 call (whichever route
    is active) to `calls`."""
    inner = lsa_ops.hungarian_assignment

    def recording(cost, num_valid=None):
        out = inner(cost, num_valid)
        calls.append((cost.detach().clone(), num_valid, out))
        return out

    lsa_ops.hungarian_assignment = recording
    try:
        yield
    finally:
        lsa_ops.hungarian_assignment = inner


def phase_plain(cfg, sd):
    """fp32, kernels vs plain versions, every decoder layer compared:
    layers 0 and 1 within PLAIN_EARLY_ATOL, so that a kernel fault shows
    before the decoder amplifies rounding, and every layer within
    PLAIN_ATOL. The launch counts prove that each forward took the route
    it claims."""
    cfg32 = dataclasses.replace(cfg, bf16=False)
    model = GraphDETR4D(cfg32)
    model.load_state_dict(sd, strict=True)
    model.eval()
    batch = synthetic_batch(cfg32, seed=0)
    images = torch.from_numpy(batch["images"]).cuda()
    l2i = torch.from_numpy(batch["lidar2img"]).cuda()
    outs, counts = {}, {}
    with torch.inference_mode():
        for route, ctx in (("kernels", contextlib.nullcontext),
                           ("plain", plain_kernels)):
            msda_ops.launches = dcn_ops.launches = 0
            with ctx():
                outs[route] = model(images, l2i)
            counts[route] = (msda_ops.launches, dcn_ops.launches)
    kern, plain = outs["kernels"], outs["plain"]
    errs = {}
    for key in ("all_cls_scores", "all_bbox_preds"):
        a, b = kern[key], plain[key]
        if not torch.isfinite(a).all():
            raise AssertionError(f"non-finite {key}")
        errs[key] = [(a[i] - b[i]).abs().max().item() for i in range(len(a))]
    emit({"phase": "plain", "dtype": "float32",
          "max_abs_err_per_layer": errs, "launches": counts,
          "cam_overflow": [float(kern["cam_overflow"]),
                           float(plain["cam_overflow"])]})
    want = {"kernels": (MSDA_CALLS, DCN_CALLS), "plain": (0, 0)}
    if counts != want:
        raise AssertionError(f"launches per route {counts} != {want}")
    for key, per_layer in errs.items():
        for i, e in enumerate(per_layer):
            tol = PLAIN_EARLY_ATOL if i < 2 else PLAIN_ATOL
            if not e <= tol:
                raise AssertionError(
                    f"kernel path vs plain path: {key} layer {i} {e} > {tol}")


def train_batch(cfg):
    return synthetic_batch(cfg, seed=0, num_gt=NUM_GT)


def phase_train(cfg, sd, work_dir):
    """Trainer at full width: 1 warm-up step, then TRAIN_STEPS timed ones
    with the launch counters counted from 0 just before them."""
    batch = train_batch(cfg)
    trainer = Trainer(cfg, sd, itertools.repeat(batch), work_dir, seed=0)
    frozen = "img_backbone.conv1.weight"
    main_w = "pts_bbox_head.cls_branches.0.0.weight"
    before = {k: trainer.model.state_dict()[k].clone()
              for k in (frozen, main_w)}
    trainer.fit(1, log_interval=1)  # warm-up: cuDNN / cuBLAS choices
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, records = [], []
    for step in range(2, TRAIN_STEPS + 2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        records += trainer.fit(step, log_interval=1)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    after = {k: trainer.model.state_dict()[k] for k in before}
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    emit({"phase": "train", "config": CONFIG, "steps": TRAIN_STEPS,
          "batch": 1, "num_gt": NUM_GT, "grid_mask": cfg.train.use_grid_mask,
          "dropout": cfg.head.dropout, "remat": cfg.backbone.remat,
          "ms_per_step": times, "mean_ms": sum(times) / len(times),
          "peak_memory_bytes": peak,
          "loss": [r["loss"] for r in records],
          "grad_norm": [r["grad_norm"] for r in records],
          "launches": launches, "launches_per_step": per_step})
    if per_step != STEP_LAUNCHES:
        raise AssertionError(f"launches per step {per_step} != {STEP_LAUNCHES}")
    for r in records:
        if not all(np.isfinite(v) for v in r.values()):
            raise AssertionError(f"non-finite train metrics {r}")
    if not torch.equal(after[frozen], before[frozen]):
        raise AssertionError(f"frozen {frozen} changed")
    if torch.equal(after[main_w], before[main_w]):
        raise AssertionError(f"main-group {main_w} did not change")
    return trainer, batch, launches


def phase_train_breakdown(trainer, batch):
    """Where one train step's time goes: its stages between CUDA events
    (the same work as TrainStep.step), and a torch.profiler trace of one
    Trainer step (device busy share of its span, top kernels)."""
    ts, dev = trainer.train_step, trainer.device
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    ev[0].record()
    b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    ev[1].record()
    for p in ts.params:
        p.grad = None
    feats = ts.model.extract_feats(b["images"], ts.generator)
    ev[2].record()
    out = ts.model.forward_feats(feats, b["lidar2img"], ts.generator)
    ev[3].record()
    total, _ = detr3d_loss(out, b["gt_bboxes"], b["gt_labels"],
                           b["gt_valid"], ts.cfg.loss, ts.cfg.head)
    ev[4].record()
    total.backward()
    ev[5].record()
    clip_by_global_norm([p.grad for p in ts.params if p.grad is not None],
                        ts.cfg.train.grad_clip_norm)
    ts.optimizer.step()
    ts.scheduler.step()
    ev[6].record()
    ev[6].synchronize()
    names = ("h2d", "backbone_neck_fwd", "head_fwd", "loss_and_matching",
             "backward", "clip_and_adamw")
    stages = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        trainer.fit(trainer.step + 1, log_interval=1)
        end.record()
        end.synchronize()
    span_ms = start.elapsed_time(end)
    events = device_events(prof)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:15]
    emit({"phase": "train_breakdown", "stages_ms": stages,
          "profiled_step_ms": span_ms, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / span_ms,
          "top_device_ms": [[e.key[:60], dev_us(e) / 1e3, e.count]
                            for e in top]})
    if busy_ms > span_ms:
        raise AssertionError(
            f"device busy {busy_ms} ms exceeds the step's {span_ms} ms")


def assignment_cost(cost, num_valid, col4row):
    """Summed cost of each problem's solved rows."""
    total = []
    c = torch.nan_to_num(cost.float(), nan=100.0, posinf=100.0, neginf=-100.0)
    for p in range(cost.shape[0]):
        n = int(num_valid[p])
        rows = torch.arange(n, device=cost.device)
        total.append(float(c[p, rows, col4row[p, :n].long()].double().sum()))
    return total


def phase_train_plain(cfg, sd):
    """One fp32 step (dropout 0, grid mask off) from the same weights
    through the kernels, then through the plain versions."""
    cfg32 = dataclasses.replace(
        cfg, bf16=False, head=dataclasses.replace(cfg.head, dropout=0.0),
        train=dataclasses.replace(cfg.train, use_grid_mask=False))
    batch = {k: torch.as_tensor(v).cuda() for k, v in train_batch(cfg32).items()}
    metrics, counts, calls = {}, {}, {}
    for route, ctx in (("kernels", contextlib.nullcontext),
                       ("plain", plain_kernels)):
        model = GraphDETR4D(cfg32)
        model.load_state_dict(sd, strict=True)
        step = TrainStep(model, cfg32, seed=0)
        calls[route] = []
        reset_launch_counts()
        with ctx(), record_assignments(calls[route]):
            m = step.step(batch)
        counts[route] = launch_counts()
        metrics[route] = {k: float(v) for k, v in m.items()}
        del model, step
        torch.cuda.empty_cache()
    kern, plain = metrics["kernels"], metrics["plain"]
    rel = {k: abs(kern[k] - plain[k]) / max(abs(plain[k]), 1e-12)
           for k in kern}
    (ck, nk, ak), = calls["kernels"]
    (cp, npl, ap), = calls["plain"]
    layers = ak.shape[0]
    differ = [int((ak[i] != ap[i]).sum()) for i in range(layers)]
    opt_k, opt_p = assignment_cost(ck, nk, ak), assignment_cost(cp, npl, ap)
    cost_rel = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(opt_k, opt_p)]
    emit({"phase": "train_plain", "dtype": "float32", "metrics": metrics,
          "rel_err": rel, "launches": counts,
          "assignment_rows_differing_per_layer": differ,
          "optimum_cost_rel_err_per_layer": cost_rel})
    want_kernels = STEP_LAUNCHES
    want_plain = dict.fromkeys(STEP_LAUNCHES, 0)
    if counts != {"kernels": want_kernels, "plain": want_plain}:
        raise AssertionError(f"launches per route {counts}")
    for k, e in rel.items():
        tol = TRAIN_PLAIN_GRAD_NORM_RTOL if k == "grad_norm" else TRAIN_PLAIN_RTOL
        if not e <= tol:
            raise AssertionError(f"train step kernels vs plain: {k} {e} > {tol}")
    for i, (d, e) in enumerate(zip(differ, cost_rel)):
        if d and not e <= 1e-5:
            raise AssertionError(
                f"layer {i}: {d} rows assigned differently and optimum "
                f"costs differ by {e}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_build()
    kernels = phase_kernels(dev)
    cfg = get_config(CONFIG)
    sd = random_state_dict(cfg)
    engine, batch, serve_launches = phase_serve(cfg, sd)
    phase_breakdown(engine, batch)
    del engine
    torch.cuda.empty_cache()
    phase_plain(cfg, sd)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work_dir:
        trainer, batch, train_launches = phase_train(cfg, sd, work_dir)
        phase_train_breakdown(trainer, batch)
        del trainer
    torch.cuda.empty_cache()
    phase_train_plain(cfg, sd)

    table = []
    for name, src, replaces, launches, covers in (
        ("msda_forward", "graph_detr4d_tpu_torch/csrc/msda.cu",
         "graph_detr4d_tpu/ops/msda.py:374", serve_launches,
         "one request's calls, bf16"),
        ("deform_im2col", "graph_detr4d_tpu_torch/csrc/deform_conv.cu",
         "graph_detr4d_tpu/ops/deform_conv.py:78", serve_launches,
         "one request's calls, bf16"),
        ("msda_backward", "graph_detr4d_tpu_torch/csrc/msda.cu",
         "graph_detr4d_tpu/ops/msda.py:374", train_launches,
         "one train step's calls, bf16"),
        ("deform_col2im", "graph_detr4d_tpu_torch/csrc/deform_conv.cu",
         "graph_detr4d_tpu/ops/deform_conv.py:78", train_launches,
         "one train step's calls, bf16"),
        ("focal_loss", "graph_detr4d_tpu_torch/csrc/focal_loss.cu",
         "graph_detr4d_tpu/ops/focal_loss.py:14", train_launches,
         "one train step's call, fp32"),
        ("hungarian", "graph_detr4d_tpu_torch/csrc/hungarian.cu",
         "graph_detr4d_tpu/ops/hungarian.py:95", train_launches,
         "one train step's call (6 layers x 128 x 900)"),
    ):
        k = kernels[name]
        if "max_abs_err" in k:
            err = k["max_abs_err"]
        else:
            err = max(v[0] for c, v in k["checks"].items()
                      if c.endswith("float32") and isinstance(v, tuple))
        table.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "train_launches": train_launches[name],
            "max_abs_err": err, "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None, "ms_covers": covers,
        })
    print(smi, flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
