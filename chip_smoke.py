#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check every kernel.

    python3 chip_smoke.py

Runs the flagship Graph-DETR4D config
(detr4d_res50_deform_pe_testaug_2subset_12e: 12 cameras at 640x1600,
ResNet-50 + DCNv2, 900 queries, 6 decoder layers, bf16) with seeded random
weights, serving (also with the int8 DCN table) and training, then the
LiDAR detector ObjDGCNN and the rotated 3D IoU, and prints one JSON line
per phase:

  1. build    nvcc for every kernel source, all started together;
  2. kernels  each kernel against its plain PyTorch version at the main
              path's shapes, fp32 (TF32 off, max abs error <= 1e-4) and
              bf16 (error <= 2e-2 of the output's max magnitude), with
              samples outside the image and both DCN strides (K2, the
              fused conv, with weights at the init scale 1 / sqrt(9 Cin));
              kernel time, plain time and the bound (least time for the
              bytes moved or the operations done; K2 also times the bare
              bf16 contraction in cuBLAS, `gemm_ref_ms`, which the old
              two-stage route paid on top of its sampling kernel). The
              backward kernels of K1 / K2 are
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
              detections and the launch counters (K1 6 and K2 forward 9
              per request), counted from 0 just before the requests;
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

  7. serve_int8  the flagship with backbone.dcn_gather=int8 answers the
              same 4 requests from the same weights: time per request, peak
              memory, launches per request exactly K3 7, K2 forward 2,
              K1 6 (the int8 table applies only to DCN inputs above 1536
              padded pixels), and, reported without a limit, the box drift
              against the exact path's answer as tools/int8_box_bound.py
              defines it
              (top-300 selection churn, max |d| of centre, size, yaw,
              velocity and score over the boxes both select), beside the
              drift of the same int8 convs through their plain version
              (quantize, column tile, cuBLAS matmul) after the timed
              requests, and the fused route's drift from that one;
  8. lidar    ObjDGCNN at the JAX module's full width (128 x 128 pillars, 64
              pillar channels, 900 queries, width 256, 6 layers, k 16), batch
              1, through serve.LidarEngine: 4 requests, each a seeded
              synthetic cloud of ~300,000 points x 5 features (clusters on a
              ground plane, ~10% outside the range, a masked padded tail);
              time per request, peak memory, valid detections, launches per
              request K6 1 + 1 and K1 6;
  9. lidar_plain  the same weights, kernels vs plain versions: launches
              (1, 1, 6) then 0, logits and boxes of layers 0-1 within 1e-4,
              of every layer within 1e-3;
 10. iou      core/iou3d.bbox_overlaps_3d (K7) on the lidar answer: the 900
              final-layer boxes against themselves and the 300 decoded boxes
              against 128 ground-truth-like boxes, against the plain version
              within 1e-5; 2 launches.
Phase `kernels` also holds K3 (the fused int8-table conv, fp32 within
1e-4 and bf16 within one bf16 step of the output's magnitude, both
strides, the flagship's 7 int8 DCN shapes, with `gemm_ref_ms` as K2's),
K6 (the lidar phase's clouds) and K7 (900 x 900 and 300 x 128) to their
plain versions, with the time of one PyTorch call that computes the same
function where there is one (K6: scatter_reduce_ 'amax' for the grid,
index_add_ for the cell sums). K1's backward is checked and timed twice:
on uniform samples (the table's row) and on samples clustered around 50
reference points per camera at 3 pixels' spread, as a trained model's
queries look at the same objects.

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

from graph_detr4d_tpu_torch.config import HeadConfig
from graph_detr4d_tpu_torch.configs import get_config
from graph_detr4d_tpu_torch.core import iou3d
from graph_detr4d_tpu_torch.core.coder import decode_batch
from graph_detr4d_tpu_torch.data.synthetic import synthetic_batch
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D
from graph_detr4d_tpu_torch.ops import build
from graph_detr4d_tpu_torch.core.losses import detr3d_loss
from graph_detr4d_tpu_torch.ops import deform_conv as dcn_ops
from graph_detr4d_tpu_torch.ops import focal_loss as focal_ops
from graph_detr4d_tpu_torch.ops import hungarian as lsa_ops
from graph_detr4d_tpu_torch.geometry.boxes import denormalize_bbox
from graph_detr4d_tpu_torch.models import dgcnn as dgcnn_mod
from graph_detr4d_tpu_torch.models.dgcnn import ObjDGCNN
from graph_detr4d_tpu_torch.ops import msda as msda_ops
from graph_detr4d_tpu_torch.ops import voxelize as vox_ops
from graph_detr4d_tpu_torch.serve import Engine, LidarEngine
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
STEP_LAUNCHES = {"msda_forward": 6, "msda_backward": 6,
                 "deform_conv_forward": 9, "deform_conv_backward": 9,
                 "focal_loss": 1, "hungarian": 1}
# fp32 kernel path vs plain path: decoder layers 0-1, and every layer
PLAIN_EARLY_ATOL, PLAIN_ATOL = 1e-4, 1e-3
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor FLOP/s,
# dense bf16 tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TENSOR_FLOPS = 989e12
# the DCN convs of one request at 640x1600 x 12 cameras: (H, W, Cin,
# stride) of the input, and how many of the 9 have that shape
DCN_SHAPES = [((80, 200, 256, 2), 1), ((40, 100, 256, 1), 5),
              ((40, 100, 512, 2), 1), ((20, 50, 512, 1), 2)]
MSDA_LEVELS = [(80, 200), (40, 100), (20, 50), (10, 25)]
# the 7 of them that take the int8 table under backbone.dcn_gather=int8
INT8_SHAPES = DCN_SHAPES[:3]
INT8_LAUNCHES = {"deform_conv_int8_forward": 7, "deform_conv_forward": 2,
                 "msda_forward": 6}  # per request
# the LiDAR detector: ObjDGCNN's defaults; clouds the size of a nuScenes
# 10-sweep cloud
LIDAR_GRID, LIDAR_POINTS, LIDAR_FEATURES = (128, 128), 300_000, 5
LIDAR_LEVELS = [(128, 128), (64, 64), (32, 32), (16, 16)]
LIDAR_LAUNCHES = {"pillar_features": 1, "pillar_scatter": 1,
                  "msda_forward": 6}  # per request
# phase lidar_plain: k-NN rows per call whose plain-route choice may differ
# (runs measured at most 2 of 900), each a near-tie: the route's own k-th
# and (k+1)-th squared distances within this relative gap
KNN_MAX_DIFFERING, KNN_TIE_RTOL = 4, 1e-5
IOU_SHAPES = [(900, 900), (300, 128)]


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
            "deform_conv_forward": dcn_ops.forward_launches,
            "deform_conv_backward": dcn_ops.backward_launches,
            "focal_loss": focal_ops.launches,
            "hungarian": lsa_ops.launches,
            "deform_conv_int8_forward": dcn_ops.int8_launches,
            "pillar_features": vox_ops.launches,
            "pillar_scatter": vox_ops.scatter_launches,
            "iou3d": iou3d.launches}


def reset_launch_counts():
    msda_ops.launches = msda_ops.backward_launches = 0
    dcn_ops.forward_launches = dcn_ops.backward_launches = 0
    focal_ops.launches = lsa_ops.launches = 0
    dcn_ops.int8_launches = 0
    vox_ops.launches = vox_ops.scatter_launches = 0
    iou3d.launches = 0


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


def bf16_step(magnitude):
    """One bf16 step (unit in the last place) at this magnitude."""
    return 2.0 ** (np.floor(np.log2(magnitude)) - 7)


def device_breakdown(fn):
    """Device time of each kernel (and memset) of one call of fn, from a
    torch.profiler trace of that call after a warm-up call:
    [[name, ms, count], ...], longest first."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [[e.key[:60], dev_us(e) / 1e3, e.count]
            for e in sorted(device_events(prof), key=dev_us, reverse=True)]


def check_close(name, got, want, dtype, bf16_tol=None):
    """fp32 within 1e-4; bf16 within bf16_tol(magnitude), by default 2e-2
    of the output's magnitude. Returns (max abs error, magnitude)."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if not np.isfinite(err):
        raise AssertionError(f"{name}: non-finite output")
    if dtype == torch.float32 and err > 1e-4:
        raise AssertionError(f"{name}: fp32 max abs error {err} > 1e-4")
    tol = (bf16_tol or (lambda m: 2e-2 * m))(scale)
    if dtype == torch.bfloat16 and err > tol:
        raise AssertionError(
            f"{name}: bf16 max abs error {err} > {tol} (magnitude {scale})")
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


def clustered_loc(gen, dev, BN, Q, heads, L, P, points=50, spread_px=3.0):
    """K1 sampling locations as a trained model's queries place them: each
    query of a camera looks around one of `points` reference points of
    that camera (uniform in [0.05, 0.95]^2), its samples at a normal
    spread of `spread_px` pixels of each level."""
    ref = torch.rand(BN, points, 2, generator=gen) * 0.9 + 0.05
    pick = torch.randint(0, points, (BN, Q), generator=gen)
    centre = ref[torch.arange(BN)[:, None], pick]  # (BN, Q, 2) as (x, y)
    size = torch.tensor([[w, h] for h, w in MSDA_LEVELS], dtype=torch.float32)
    noise = torch.randn(BN, Q, heads, L, P, 2, generator=gen) * spread_px
    loc = centre[:, :, None, None, None, :] + noise / size[:, None, :]
    return loc.contiguous().to(dev)


def msda_backward_record(label, value32, loc, attn, index, gen, dev,
                         plain=True):
    """K1's backward on these samples: checked against the plain version
    (fp32 and bf16, with and without the index list) and timed in bf16
    with the index list, per train step (the plain version too, with
    `plain`)."""
    BN, Q, heads, L, P = attn.shape
    hd = value32.shape[-1]
    R = index.shape[1]
    kinks = msda_kinks(loc, MSDA_LEVELS)
    checks = {"samples_near_kink": int(kinks.sum())}
    for dtype in (torch.float32, torch.bfloat16):
        value = value32.to(dtype)
        for name, idx in (("index", index), ("all", None)):
            g = (torch.randn(BN, R if idx is not None else Q, heads * hd,
                             generator=gen)).to(dev, dtype)
            got = msda_ops.msda_backward(value, MSDA_LEVELS, loc, attn, g, idx)
            want = msda_ops.msda_backward_plain(value, MSDA_LEVELS, loc, attn,
                                                g, idx)
            checks[f"{name}_{str(dtype)[6:]}"] = check_grads_close(
                f"msda_backward {label} {name} {dtype}", got, want, dtype,
                skip={1: kinks})
            del got, want
    value = value32.to(torch.bfloat16)
    g = torch.randn(BN, R, heads * hd, generator=gen).to(dev, torch.bfloat16)
    ms = cuda_ms(lambda: msda_ops.msda_backward(value, MSDA_LEVELS, loc, attn,
                                                g, index), 20)
    bound, bound_by = msda_backward_bound_ms(value, loc, attn, index)
    rows, _ = touched_value_rows(value, loc, attn, index, False)
    breakdown = device_breakdown(lambda: msda_ops.msda_backward(
        value, MSDA_LEVELS, loc, attn, g, index))
    record = dict(checks=checks, ms=ms * MSDA_CALLS, per_call_ms=ms,
                  bound_ms=bound * MSDA_CALLS, bound_by=bound_by,
                  touched_value_rows=rows, device_ms_per_call=breakdown)
    if plain:
        record["plain_ms"] = MSDA_CALLS * cuda_ms(
            lambda: msda_ops.msda_backward_plain(value, MSDA_LEVELS, loc,
                                                 attn, g, index), 3)
    return record


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


def dcn_peak_flops(x):
    return PEAK_BF16_TENSOR_FLOPS if x.dtype == torch.bfloat16 else PEAK_FP32_FLOPS


def dcn_bound_ms(x, offsets, w):
    """Least time for one fused K2 or K3 forward call: x, offsets, mask
    and the (9 Cin, Cout) weight read once and the (B, Ho, Wo, Cout)
    output written once (x's dtype), over HBM bandwidth; or the
    contraction's 2 M 9Cin Cout FLOPs over the tensor-core rate of x's
    dtype. K3's int8 table is an intermediate of its design, not of the
    function, and counts no bytes."""
    B, H, W, C = x.shape
    npix = B * offsets.shape[1] * offsets.shape[2]
    cout = w.shape[1]
    bytes_ = (x.numel() + npix * 27 + w.numel() + npix * cout) * x.element_size()
    t_bytes = bytes_ / PEAK_BYTES_PER_S
    t_ops = 2 * npix * 9 * C * cout / dcn_peak_flops(x)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def dcn_backward_bound_ms(x, offsets, w):
    """Least time for one fused K2 backward call: x, offsets, mask, the
    weight and grad_out read once, grad_x, grad_offsets, grad_mask and
    grad_w written once (x's dtype); or the two contractions' 4 M 9Cin
    Cout FLOPs (G = grad_out W^T and grad_w = A^T grad_out) over the
    tensor-core rate of x's dtype."""
    B, H, W, C = x.shape
    npix = B * offsets.shape[1] * offsets.shape[2]
    cout = w.shape[1]
    bytes_ = (2 * (x.numel() + npix * 27 + w.numel()) + npix * cout) * x.element_size()
    t_bytes = bytes_ / PEAK_BYTES_PER_S
    t_ops = 4 * npix * 9 * C * cout / dcn_peak_flops(x)
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


def kernel_msda(dev, gen):
    """K1 forward and backward at the main path's call, against their plain
    versions; the backward also on clustered samples. Returns the two
    records."""
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

    # K1 backward: the same inputs, grad_out of the output's shape; then
    # samples clustered around 50 points a camera, with their own generator
    # so that the later kernels' inputs stay those of earlier runs
    results["msda_backward"] = msda_backward_record(
        "uniform", value32, loc, attn, index, gen, dev)
    cgen = torch.Generator(device="cpu").manual_seed(1)
    results["msda_backward"]["clustered"] = msda_backward_record(
        "clustered", value32, clustered_loc(cgen, dev, BN, Q, heads, L, P),
        attn, index, cgen, dev, plain=False)
    emit({"phase": "kernels", "kernel": "msda_backward",
          "shape": [BN, Q, R, heads, hd, L, P], **results["msda_backward"]})
    del value32, value
    return results["msda_forward"], results["msda_backward"]


def phase_kernels(dev):
    gen = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def rand(*shape):
        return torch.rand(*shape, generator=gen).to(dev)

    results = {}
    results["msda_forward"], results["msda_backward"] = kernel_msda(dev, gen)

    # K2 forward and backward (the fused conv) at the 4 DCN shapes of one
    # request, both strides, Cout = Cin (ResNet-50's bottleneck widths),
    # weights at the init scale 1 / sqrt(9 Cin) so that outputs are O(1)
    fwd, bwd = ({"checks": {}, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                 "gemm_ref_ms": 0.0, "max_abs_err": 0.0, "by": set()}
                for _ in range(2))
    for (H, W, C, stride), count in DCN_SHAPES:
        Ho, Wo = dcn_ops.output_size(H, stride, 1), dcn_ops.output_size(W, stride, 1)
        x32 = randn(12, H, W, C)
        off32 = randn(12, Ho, Wo, 9, 2) * 3.0  # some taps land outside
        mask32 = rand(12, Ho, Wo, 9)
        w32 = randn(9 * C, C) / np.sqrt(9 * C)
        g32 = randn(12, Ho, Wo, C)
        tag = f"{H}x{W}x{C}_s{stride}"
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype)[6:]
            x, off, mask, w, g = (t.to(dtype) for t in (x32, off32, mask32, w32, g32))
            kinks = dcn_kinks(off, stride)
            bwd["checks"][f"{tag}_{dt}_near_kink"] = int(kinks.sum())
            got = dcn_ops.deform_conv_forward(x, off, mask, w, stride)
            want = dcn_ops.deform_conv2d_plain(x, off, mask, w, stride)
            fwd["checks"][f"{tag}_{dt}"] = check_close(
                f"deform_conv_forward {tag} {dtype}", got, want, dtype)
            del got, want
            got = dcn_ops.deform_conv_backward(x, off, mask, w, g, stride)
            want = dcn_ops.deform_conv2d_backward_plain(x, off, mask, w, g, stride)
            bwd["checks"][f"{tag}_{dt}"] = check_grads_close(
                f"deform_conv_backward {tag} {dtype}", got, want, dtype,
                skip={1: kinks})
            if dtype == torch.float32:
                for rec in (fwd, bwd):
                    rec["max_abs_err"] = max(rec["max_abs_err"],
                                             rec["checks"][f"{tag}_{dt}"][0])
            del got, want
        x, off, mask, w, g = (t.to(torch.bfloat16)
                              for t in (x32, off32, mask32, w32, g32))
        # the bare contraction in cuBLAS, at the same shapes: what the old
        # route ran after its sampling kernel (once forward, twice backward)
        a = torch.randn(12 * Ho * Wo, 9 * C, device=dev, dtype=torch.bfloat16)
        gemm_ms = count * cuda_ms(lambda: torch.matmul(a, w), 20)
        del a
        # the backward's data-gradient kernel alone (no weight gradient)
        bwd["data_grad_ms"] = bwd.get("data_grad_ms", 0.0) + count * cuda_ms(
            lambda: dcn_ops.deform_conv_backward(x, off, mask, w, g, stride,
                                                 weight_grad=False), 20)
        for rec, fn, plain, bound_fn in (
            (fwd, lambda: dcn_ops.deform_conv_forward(x, off, mask, w, stride),
             lambda: dcn_ops.deform_conv2d_plain(x, off, mask, w, stride),
             dcn_bound_ms),
            (bwd, lambda: dcn_ops.deform_conv_backward(x, off, mask, w, g, stride),
             lambda: dcn_ops.deform_conv2d_backward_plain(x, off, mask, w, g,
                                                          stride),
             dcn_backward_bound_ms),
        ):
            rec["ms"] += count * cuda_ms(fn, 20)
            rec["plain_ms"] += count * cuda_ms(plain, 3)
            rec["gemm_ref_ms"] += gemm_ms
            b, b_by = bound_fn(x, off, w)
            rec["bound_ms"] += count * b
            rec["by"].add(b_by)
        del x32, off32, mask32, w32, g32, x, off, mask, w, g
        torch.cuda.empty_cache()
    for name, rec in (("deform_conv_forward", fwd), ("deform_conv_backward", bwd)):
        by = rec.pop("by")
        results[name] = dict(rec, bound_by="bytes" if by == {"bytes"}
                             else "operations")
        emit({"phase": "kernels", "kernel": name, "shapes": DCN_SHAPES,
              **results[name]})

    results["focal_loss"] = kernel_focal_loss(dev, gen)
    results["hungarian"] = kernel_hungarian(dev, gen)
    results["deform_conv_int8_forward"] = kernel_int8(dev, gen)
    results["pillar_features"], results["pillar_scatter"] = kernel_voxelize(
        dev, gen)
    results["iou3d"] = kernel_iou3d(dev)
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


def kernel_int8(dev, gen):
    """K3, the fused int8-table conv, at the 7 DCN convs of one request
    that take the int8 table (12 images, both strides, Cout = Cin, weights
    at the init scale), fp32 and bf16, against deform_conv2d_int8_plain;
    bf16 times summed over the request's calls, and cuBLAS's bare
    contraction at the same shapes (`gemm_ref_ms`, which the old route
    paid after its column tile)."""
    rec = {"checks": {}, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "gemm_ref_ms": 0.0, "max_abs_err": 0.0}
    by = set()
    for (H, W, C, stride), count in INT8_SHAPES:
        assert dcn_ops.select_variant(H, W, "int8") == "int8"
        Ho, Wo = dcn_ops.output_size(H, stride, 1), dcn_ops.output_size(W, stride, 1)
        x32 = torch.randn(12, H, W, C, generator=gen).to(dev)
        off32 = (torch.randn(12, Ho, Wo, 9, 2, generator=gen) * 3.0).to(dev)
        mask32 = torch.rand(12, Ho, Wo, 9, generator=gen).to(dev)
        w32 = (torch.randn(9 * C, C, generator=gen) / np.sqrt(9 * C)).to(dev)
        tag = f"{H}x{W}x{C}_s{stride}"
        for dtype in (torch.float32, torch.bfloat16):
            x, off, mask, w = (t.to(dtype) for t in (x32, off32, mask32, w32))
            got = dcn_ops.deform_conv_int8_forward(x, off, mask, w, stride)
            want = dcn_ops.deform_conv2d_int8_plain(x, off, mask, w, stride)
            rec["checks"][f"{tag}_{str(dtype)[6:]}"] = check_close(
                f"deform_conv_int8_forward {tag} {dtype}", got, want, dtype,
                bf16_tol=bf16_step)
            if dtype == torch.float32:
                rec["max_abs_err"] = max(rec["max_abs_err"],
                                         rec["checks"][f"{tag}_float32"][0])
            del got, want
        x, off, mask, w = (t.to(torch.bfloat16)
                           for t in (x32, off32, mask32, w32))
        rec["ms"] += count * cuda_ms(
            lambda: dcn_ops.deform_conv_int8_forward(x, off, mask, w, stride), 20)
        rec.setdefault("device_ms_per_call", {})[tag] = device_breakdown(
            lambda: dcn_ops.deform_conv_int8_forward(x, off, mask, w, stride))
        rec["plain_ms"] += count * cuda_ms(
            lambda: dcn_ops.deform_conv2d_int8_plain(x, off, mask, w, stride), 3)
        a = torch.randn(12 * Ho * Wo, 9 * C, device=dev, dtype=torch.bfloat16)
        rec["gemm_ref_ms"] += count * cuda_ms(lambda: torch.matmul(a, w), 20)
        del a
        b, b_by = dcn_bound_ms(x, off, w)
        rec["bound_ms"] += count * b
        by.add(b_by)
        del x32, off32, mask32, w32, x, off, mask, w
        torch.cuda.empty_cache()
    rec["bound_by"] = "bytes" if by == {"bytes"} else "operations"
    emit({"phase": "kernels", "kernel": "deform_conv_int8_forward",
          "shapes": INT8_SHAPES, **rec})
    return rec


def lidar_cloud(seed, n=LIDAR_POINTS):
    """A synthetic 10-sweep LiDAR cloud: (1, n, 5) float32 (x, y, z,
    intensity, time lag) and its (1, n) mask. ~60% ground returns on a
    plane out to 60 m (the part beyond the 51.2 m range falls outside),
    ~30% on 60 box-shaped objects, ~3% above or below the z range, and a
    masked padded tail of zeros (the last 7%)."""
    rng = np.random.RandomState(seed)
    n_pad, n_obj, n_z = n * 7 // 100, n * 30 // 100, n * 3 // 100
    n_ground = n - n_pad - n_obj - n_z
    r = 60.0 * np.sqrt(rng.rand(n_ground))
    th = rng.rand(n_ground) * 2 * np.pi
    ground = np.stack([r * np.cos(th), r * np.sin(th),
                       -1.8 + 0.05 * rng.randn(n_ground)], -1)
    centre = rng.uniform(-50, 50, (60, 2))
    size = rng.uniform(0.6, 1.4, (60, 1)) * np.array([4.5, 1.9, 1.6])
    yaw = rng.uniform(-np.pi, np.pi, 60)
    k = rng.randint(0, 60, n_obj)
    local = (rng.rand(n_obj, 3) - 0.5) * size[k]
    c, s_ = np.cos(yaw[k]), np.sin(yaw[k])
    objects = np.stack([centre[k, 0] + c * local[:, 0] - s_ * local[:, 1],
                        centre[k, 1] + s_ * local[:, 0] + c * local[:, 1],
                        -1.8 + local[:, 2] + size[k, 2] / 2], -1)
    z_out = np.stack([rng.uniform(-50, 50, n_z), rng.uniform(-50, 50, n_z),
                      np.where(rng.rand(n_z) < 0.5, rng.uniform(3, 6, n_z),
                               rng.uniform(-8, -5, n_z))], -1)
    xyz = np.concatenate([ground, objects, z_out])[rng.permutation(n - n_pad)]
    pts = np.zeros((1, n, LIDAR_FEATURES), np.float32)
    pts[0, : n - n_pad, :3] = xyz
    pts[0, : n - n_pad, 3] = rng.rand(n - n_pad)
    pts[0, : n - n_pad, 4] = rng.randint(0, 10, n - n_pad) * 0.05
    mask = np.zeros((1, n), np.float32)
    mask[0, : n - n_pad] = 1.0
    return pts, mask


def kernel_voxelize(dev, gen):
    """K6 at the lidar phase's first cloud: kernels A + B (ids and
    augmented rows) and kernel C (max-scatter of 64-channel features,
    negative values included) against their plain versions, and the
    PyTorch calls that compute their cores (index_add_ of the cell xyz
    sums; scatter_reduce_ 'amax' of the grid)."""
    pts_np, mask_np = lidar_cloud(0)
    pts, mask = torch.from_numpy(pts_np).to(dev), torch.from_numpy(mask_np).to(dev)
    pc = HeadConfig().pc_range
    H, W = LIDAR_GRID
    ids, aug = vox_ops.pillar_features(pts, mask, pc, LIDAR_GRID)
    want_ids, want_aug = vox_ops.pillar_features_plain(pts, mask, pc, LIDAR_GRID)
    ids_differ = int((ids != want_ids).sum())
    aug_err = (aug - want_aug).abs().max().item()
    trash = float((ids == H * W).float().mean())
    if ids_differ or not aug_err <= 1e-5:
        raise AssertionError(f"pillar_features: {ids_differ} ids differ, "
                             f"rows {aug_err} > 1e-5")
    P = pts.shape[1]
    seg = ids.long().reshape(-1)
    xyz = pts[0, :, :3].contiguous()
    sums = torch.zeros(H * W + 1, 3, device=dev)
    feat_bytes = P * (LIDAR_FEATURES * 4 + 4 + 4 + (LIDAR_FEATURES + 5) * 4)
    features = dict(
        checks={"ids_differing": ids_differ, "rows_max_abs_err": aug_err,
                "trash_share": trash},
        max_abs_err=aug_err,
        ms=cuda_ms(lambda: vox_ops.pillar_features(pts, mask, pc, LIDAR_GRID), 20),
        plain_ms=cuda_ms(lambda: vox_ops.pillar_features_plain(
            pts, mask, pc, LIDAR_GRID), 3),
        library_ms=cuda_ms(lambda: sums.index_add_(0, seg, xyz), 20),
        bound_ms=1e3 * feat_bytes / PEAK_BYTES_PER_S, bound_by="bytes")
    emit({"phase": "kernels", "kernel": "pillar_features",
          "shape": [1, P, LIDAR_FEATURES], "grid": LIDAR_GRID, **features})

    feats = (torch.randn(1, P, 64, generator=gen) - 0.5).to(dev)
    got = vox_ops.pillar_scatter(feats, ids, LIDAR_GRID)
    want = vox_ops.pillar_scatter_plain(feats, ids, LIDAR_GRID)
    if not torch.equal(got, want):
        raise AssertionError("pillar_scatter: max differs from the plain "
                             f"version by {(got - want).abs().max().item()}")
    idx = seg[:, None].expand(-1, 64)
    grid = torch.zeros(H * W + 1, 64, device=dev)
    scatter_bytes = P * 64 * 4 + P * 4 + H * W * 64 * 4
    scatter = dict(
        checks={"equal": True, "negative_cells": int((got < 0).sum())},
        max_abs_err=0.0,
        ms=cuda_ms(lambda: vox_ops.pillar_scatter(feats, ids, LIDAR_GRID), 20),
        plain_ms=cuda_ms(lambda: vox_ops.pillar_scatter_plain(
            feats, ids, LIDAR_GRID), 3),
        library_ms=cuda_ms(lambda: grid.scatter_reduce_(
            0, idx, feats[0], "amax", include_self=False), 20),
        bound_ms=1e3 * scatter_bytes / PEAK_BYTES_PER_S, bound_by="bytes")
    emit({"phase": "kernels", "kernel": "pillar_scatter",
          "shape": [1, P, 64], "grid": LIDAR_GRID, **scatter})
    return features, scatter


def random_boxes(rng, n, near=None):
    """(n, 7) boxes within the 51.2 m range; with `near`, jittered copies
    of rows of `near`, so that pairs overlap."""
    if near is not None:
        b = near[rng.randint(0, len(near), n)].copy()
        b[:, :2] += rng.uniform(-1.5, 1.5, (n, 2))
        b[:, 6] += rng.uniform(-0.6, 0.6, n)
        return b.astype(np.float32)
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-50, 50, (n, 2))
    b[:, 2] = rng.uniform(-2, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 5.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def iou_operations(b1, b2):
    """About the float operations K7 does on these boxes: per clip step 10
    per vertex it tests (two side tests) and 9 per vertex it emits (a
    crossing at most), then 3 per vertex of the shoelace and 12 for the
    z overlap and the ratio: counted from this run's polygons."""
    c1, c2 = iou3d.box_corners_bev(b1), iou3d.box_corners_bev(b2)
    M, N = c1.shape[0], c2.shape[0]
    p1 = c1[:, None].expand(M, N, 4, 2).reshape(M * N, 4, 2)
    p2 = c2[None].expand(M, N, 4, 2).reshape(M * N, 4, 2)
    pts = torch.cat([p1, p1[:, :1].expand(-1, iou3d.V_MAX - 4, 2)], dim=1)
    count = torch.full((M * N,), 4, dtype=torch.long, device=b1.device)
    ops = 0
    for i in range(4):
        tested = int(count.sum())
        pts, count = iou3d._clip_poly(pts, count, p2[:, i], p2[:, (i + 1) % 4])
        ops += 10 * tested + 9 * int(count.sum())
    return ops + 3 * int(count.sum()) + 12 * M * N


def kernel_iou3d(dev):
    """K7 at the iou phase's shapes, 900 x 900 and 300 x 128 boxes 50 m
    out, against the plain version (1e-5)."""
    rng = np.random.RandomState(0)
    rec = {"checks": {}, "ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0}
    ops = 0
    for M, N in IOU_SHAPES:
        b1 = random_boxes(rng, M)
        b2 = random_boxes(rng, N, near=b1)
        b1, b2 = torch.from_numpy(b1).to(dev), torch.from_numpy(b2).to(dev)
        for mode in ("iou", "iof"):
            got = iou3d.bbox_overlaps_3d(b1, b2, mode)
            want = iou3d.bbox_overlaps_3d_plain(b1, b2, mode)
            err = (got - want).abs().max().item()
            if not err <= 1e-5:
                raise AssertionError(f"iou3d {M}x{N} {mode}: {err} > 1e-5")
            rec["checks"][f"{M}x{N}_{mode}"] = [err, int((want > 0.1).sum())]
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["ms"] += cuda_ms(lambda: iou3d.bbox_overlaps_3d(b1, b2), 20)
        rec["plain_ms"] += cuda_ms(lambda: iou3d.bbox_overlaps_3d_plain(b1, b2), 3)
        ops += iou_operations(b1, b2)
        torch.cuda.empty_cache()
    t_ops = ops / PEAK_FP32_FLOPS
    t_bytes = sum((M + N) * 7 * 4 + M * N * 4 for M, N in IOU_SHAPES) / PEAK_BYTES_PER_S
    rec.update(bound_ms=1e3 * max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               operations=ops)
    emit({"phase": "kernels", "kernel": "iou3d", "shapes": IOU_SHAPES, **rec})
    return rec


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
                deform_conv_forward=DCN_CALLS * REQUESTS)
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


def final_layer(engine, batch):
    """The final decoder layer's logits and codes for one request."""
    with torch.inference_mode():
        out = engine.model(torch.as_tensor(batch["images"]).to(engine.device),
                           torch.as_tensor(batch["lidar2img"]).to(engine.device))
    return out["all_cls_scores"][-1].float(), out["all_bbox_preds"][-1].float()


def top_selection(cls, codes, max_num):
    """The NMS-free coder's ranking: the top `max_num` flat (query, class)
    indices by sigmoid score (stable), their scores and decoded boxes."""
    scores = torch.sigmoid(cls).flatten(-2)
    top, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top, idx = top[..., :max_num], idx[..., :max_num]
    C = cls.shape[-1]
    q = (idx // C)[..., None].expand(*idx.shape, codes.shape[-1])
    return idx, top, denormalize_bbox(torch.gather(codes, -2, q))


def box_drift(ref, got, max_num):
    """tools/int8_box_bound.py's box-level drift of `got` against `ref`
    (final-layer logits and codes): top-max_num selection churn, and the
    max |d| of centre (m), size, yaw (rad, wrapped), velocity and score
    over the (query, class) pairs both select."""
    ia, sa, ba = (t[0].cpu() for t in top_selection(*ref, max_num))
    ib, sb, bb = (t[0].cpu() for t in top_selection(*got, max_num))
    pos_b = {int(v): j for j, v in enumerate(ib)}
    churn = len(set(ia.tolist()) - set(ib.tolist()))
    d = dict.fromkeys(("center", "size", "yaw", "velocity", "score"), 0.0)
    matched = 0
    for i, v in enumerate(ia.tolist()):
        j = pos_b.get(v)
        if j is None:
            continue
        matched += 1
        d["center"] = max(d["center"], (ba[i, :3] - bb[j, :3]).abs().max().item())
        d["size"] = max(d["size"], (ba[i, 3:6] - bb[j, 3:6]).abs().max().item())
        dy = abs(ba[i, 6].item() - bb[j, 6].item())
        d["yaw"] = max(d["yaw"], min(dy, abs(dy - 2 * np.pi)))
        d["velocity"] = max(d["velocity"], (ba[i, 7:9] - bb[j, 7:9]).abs().max().item())
        d["score"] = max(d["score"], abs(sa[i].item() - sb[j].item()))
    return {"selected": max_num, "churn": churn, "matched": matched,
            "max_abs_delta": d}


def phase_serve_int8(sd, batch, ref):
    """The flagship with backbone.dcn_gather=int8, the same weights and
    requests as phase serve; `ref` is the exact path's final layer."""
    cfg = get_config(CONFIG, ["backbone.dcn_gather=int8"])
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
    fused = final_layer(engine, batch)
    # a second witness, outside the timed requests: the same int8 convs
    # through their plain version (quantize, column tile, cuBLAS matmul)
    with plain_kernels(INT8_ROUTE):
        plain = final_layer(engine, batch)
    max_num = cfg.coder.max_num
    r = results[-1]
    emit({"phase": "serve_int8", "config": CONFIG, "dcn_gather": "int8",
          "requests": REQUESTS, "ms_per_request": times,
          "mean_ms": sum(times) / len(times), "peak_memory_bytes": peak,
          "cam_overflow": r["cam_overflow"],
          "valid_detections": int(r["valid"].sum()), "launches": launches,
          "drift_vs_shift4": box_drift(ref, fused, max_num),
          "plain_int8_drift_vs_shift4": box_drift(ref, plain, max_num),
          "drift_vs_plain_int8": box_drift(plain, fused, max_num)})
    want = dict.fromkeys(launches, 0)
    want.update({k: v * REQUESTS for k, v in INT8_LAUNCHES.items()})
    if launches != want:
        raise AssertionError(f"int8 launch counts {launches} != {want}")
    if r["bboxes"].shape != (1, cfg.coder.max_num, 9):
        raise AssertionError(f"bboxes shape {r['bboxes'].shape}")
    for k in ("bboxes", "scores"):
        if not np.isfinite(r[k]).all():
            raise AssertionError(f"int8: non-finite {k}")
    if not all(np.array_equal(x["labels"], r["labels"]) for x in results):
        raise AssertionError("int8: repeated requests disagree")
    return launches


def lidar_state_dict():
    """Seeded random weights of the full-width ObjDGCNN."""
    model = ObjDGCNN(device="cpu")
    init_weights(model, seed=0)
    return model.state_dict()


def phase_lidar(sd):
    """serve.LidarEngine answers REQUESTS synthetic clouds (seeds 0..)."""
    clouds = [lidar_cloud(seed) for seed in range(REQUESTS)]
    engine = LidarEngine(sd)  # warms up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, results = [], []
    for pts, mask in clouds:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        r = engine.infer(pts, mask)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        results.append(r)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    pts, mask = clouds[0]
    H, W = LIDAR_GRID
    pc = HeadConfig().pc_range
    ids, _ = vox_ops.pillar_features_plain(
        torch.from_numpy(pts), torch.from_numpy(mask), pc, LIDAR_GRID)
    emit({"phase": "lidar", "model": "ObjDGCNN", "grid": LIDAR_GRID,
          "points": LIDAR_POINTS, "features": LIDAR_FEATURES,
          "valid_points": int(mask.sum()),
          "in_range_points": int((ids < H * W).sum()),
          "occupied_pillars": int(torch.unique(ids[ids < H * W]).numel()),
          "requests": REQUESTS, "ms_per_request": times,
          "mean_ms": sum(times) / len(times), "peak_memory_bytes": peak,
          "valid_detections": [int(x["valid"].sum()) for x in results],
          "launches": launches})
    want = dict.fromkeys(launches, 0)
    want.update({k: v * REQUESTS for k, v in LIDAR_LAUNCHES.items()})
    if launches != want:
        raise AssertionError(f"lidar launch counts {launches} != {want}")
    for r in results:
        if r["bboxes"].shape != (1, 300, 9):
            raise AssertionError(f"lidar bboxes shape {r['bboxes'].shape}")
        for k in ("bboxes", "scores"):
            if not np.isfinite(r[k]).all():
                raise AssertionError(f"lidar: non-finite {k}")
    return engine, clouds, launches


@contextlib.contextmanager
def knn_route(calls, replay=False):
    """Record each k-NN selection of the LiDAR head (models/dgcnn.py::
    knn_farthest, two per decoder layer) into `calls`; or, with replay,
    hand back the recorded selections in order and yield, per call, the
    relative gaps (d_k - d_k+1) / |d_k| between this route's own k-th and
    (k+1)-th largest squared distance on the rows whose own selection
    would have been another set."""
    inner = dgcnn_mod.knn_farthest
    recorded = iter(list(calls))
    tie_gaps = []

    def route(x, k):
        own = inner(x, k)
        if not replay:
            calls.append(own)
            return own
        rec = next(recorded)
        same = (own.sort(-1).values == rec.sort(-1).values).all(-1)
        sq = (x * x).sum(-1)
        d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.matmul(
            x, x.transpose(1, 2))
        top = torch.topk(d2[~same], k + 1, dim=-1).values
        gap = (top[:, k - 1] - top[:, k]) / top[:, k - 1].abs()
        tie_gaps.append(gap.tolist())
        return rec

    dgcnn_mod.knn_farthest = route
    try:
        yield tie_gaps
    finally:
        dgcnn_mod.knn_farthest = inner


def phase_lidar_plain(sd, cloud):
    """fp32 ObjDGCNN, kernels vs plain versions, every decoder layer
    compared as in phase plain. The head's k-NN picks the 16 farthest of
    900 queries, a discontinuous choice: where two distances tie within
    the routes' rounding, the two routes pick different sets and that
    query's features jump (from layer 2 on, in the first run). So the
    plain route reuses the kernel route's neighbour sets; the rows whose
    own choice would differ must be few (KNN_MAX_DIFFERING per call) and
    real near-ties (own k-th and (k+1)-th distance within KNN_TIE_RTOL),
    and the free-running difference is reported too."""
    model = ObjDGCNN()
    model.load_state_dict(sd, strict=True)
    model.eval()
    pts, mask = (torch.from_numpy(a).cuda() for a in cloud)
    outs, counts, knn = {}, {}, []
    routes = (("kernels", contextlib.nullcontext, False),
              ("plain", plain_kernels, True),
              ("plain_free", plain_kernels, None))
    with torch.inference_mode():
        for route, ctx, replay in routes:
            reset_launch_counts()
            knn_ctx = (contextlib.nullcontext([]) if replay is None
                       else knn_route(knn, replay))
            with ctx(), knn_ctx as gaps:
                outs[route] = model(pts, mask)
            if replay:
                tie_gaps = gaps
            c = launch_counts()
            counts[route] = [c[k] for k in LIDAR_LAUNCHES]
    errs = {}
    for route in ("plain", "plain_free"):
        errs[route] = {}
        for key in ("all_cls_scores", "all_bbox_preds"):
            a, b = outs["kernels"][key], outs[route][key]
            if not torch.isfinite(a).all():
                raise AssertionError(f"lidar: non-finite {key}")
            errs[route][key] = [(a[i] - b[i]).abs().max().item()
                                for i in range(len(a))]
    emit({"phase": "lidar_plain", "dtype": "float32",
          "max_abs_err_per_layer": errs["plain"],
          "knn_rows_differing_per_call": [len(g) for g in tie_gaps],
          "knn_tie_gaps_per_call": tie_gaps,
          "free_running_max_abs_err_per_layer": errs["plain_free"],
          "launches": counts})
    want = {"kernels": list(LIDAR_LAUNCHES.values()),
            "plain": [0] * len(LIDAR_LAUNCHES),
            "plain_free": [0] * len(LIDAR_LAUNCHES)}
    if counts != want:
        raise AssertionError(f"lidar launches per route {counts} != {want}")
    if len(tie_gaps) != 2 * model.head_cfg.num_decoder_layers or not all(
            len(g) <= KNN_MAX_DIFFERING and all(0 <= x < KNN_TIE_RTOL for x in g)
            for g in tie_gaps):
        raise AssertionError(f"k-NN rows differing per call, with their "
                             f"relative k-th distance gaps: {tie_gaps}")
    for key, per_layer in errs["plain"].items():
        for i, e in enumerate(per_layer):
            tol = PLAIN_EARLY_ATOL if i < 2 else PLAIN_ATOL
            if not e <= tol:
                raise AssertionError(
                    f"lidar kernel path vs plain path: {key} layer {i} "
                    f"{e} > {tol}")


def phase_iou(engine, cloud):
    """core/iou3d.bbox_overlaps_3d on the lidar answer: the final layer's
    900 boxes against themselves, the 300 decoded boxes against 128
    ground-truth-like boxes (jittered copies of half of them, and random
    ones). Counters from 0 just before the two calls."""
    pts, mask = (torch.from_numpy(a).to(engine.device) for a in cloud)
    with torch.inference_mode():
        out = engine.model(pts, mask)
    boxes = denormalize_bbox(out["all_bbox_preds"][-1, 0].float())[:, :7]
    det = torch.from_numpy(engine.infer(*cloud)["bboxes"][0, :, :7]).to(
        engine.device)
    rng = np.random.RandomState(1)
    gt = np.concatenate([random_boxes(rng, 64, near=det.cpu().numpy()),
                         random_boxes(rng, 64)])
    gt = torch.from_numpy(gt).to(engine.device)
    boxes, det = boxes.contiguous(), det.contiguous()
    reset_launch_counts()
    ious = [iou3d.bbox_overlaps_3d(boxes, boxes), iou3d.bbox_overlaps_3d(det, gt)]
    torch.cuda.synchronize()
    launches = launch_counts()
    errs = [(i - iou3d.bbox_overlaps_3d_plain(a, b)).abs().max().item()
            for i, (a, b) in zip(ious, ((boxes, boxes), (det, gt)))]
    diag = torch.diagonal(ious[0])
    emit({"phase": "iou", "shapes": [list(i.shape) for i in ious],
          "max_abs_err_vs_plain": errs, "launches": launches,
          "self_iou_min": diag.min().item(),
          "iou_max": max(i.max().item() for i in ious),
          "pairs_above_0.1": [int((i > 0.1).sum()) for i in ious]})
    want = dict.fromkeys(launches, 0)
    want["iou3d"] = 2
    if launches != want:
        raise AssertionError(f"iou launch counts {launches} != {want}")
    for i, e in zip(ious, errs):
        if not (torch.isfinite(i).all() and e <= 1e-5):
            raise AssertionError(f"iou: non-finite or {e} > 1e-5 from plain")
        # 1 up to the shoelace's rounding over absolute coordinates, ~1e-4
        # for a 1 m^2 box 50 m out, either way (tests/test_torch_iou3d.py)
        if not (i.min() >= 0 and i.max() <= 1.01):
            raise AssertionError(f"iou outside [0, 1.01]: {i.max().item()}")
    if not diag.min() > 0.99:  # a box against itself
        raise AssertionError(f"self IoU {diag.min().item()}")
    return launches


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
                 (dcn_ops, "deform_conv", "deform_conv2d_plain"),
                 (dcn_ops, "deform_conv_int8_forward", "deform_conv2d_int8_plain"),
                 (vox_ops, "pillar_features", "pillar_features_plain"),
                 (vox_ops, "pillar_scatter", "pillar_scatter_plain"),
                 (iou3d, "bbox_overlaps_3d", "bbox_overlaps_3d_plain"),
                 (focal_ops, "sigmoid_focal_loss", "sigmoid_focal_loss_plain"),
                 (lsa_ops, "hungarian_assignment",
                  "hungarian_assignment_plain"))
INT8_ROUTE = KERNEL_ROUTES[2:3]


@contextlib.contextmanager
def plain_kernels(routes=KERNEL_ROUTES):
    """Route the model's and the loss's kernel calls (those of `routes`)
    to the plain versions (autograd differentiates those, so no backward
    kernel runs either)."""
    saved = [getattr(m, k) for m, k, _ in routes]
    for m, k, plain in routes:
        setattr(m, k, getattr(m, plain))
    try:
        yield
    finally:
        for (m, k, _), fn in zip(routes, saved):
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
            msda_ops.launches = dcn_ops.forward_launches = 0
            with ctx():
                outs[route] = model(images, l2i)
            counts[route] = (msda_ops.launches, dcn_ops.forward_launches)
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
    want_step = {**dict.fromkeys(launches, 0), **STEP_LAUNCHES}
    emit({"phase": "train", "config": CONFIG, "steps": TRAIN_STEPS,
          "batch": 1, "num_gt": NUM_GT, "grid_mask": cfg.train.use_grid_mask,
          "dropout": cfg.head.dropout, "remat": cfg.backbone.remat,
          "ms_per_step": times, "mean_ms": sum(times) / len(times),
          "peak_memory_bytes": peak,
          "loss": [r["loss"] for r in records],
          "grad_norm": [r["grad_norm"] for r in records],
          "launches": launches, "launches_per_step": per_step})
    if per_step != want_step:
        raise AssertionError(f"launches per step {per_step} != {want_step}")
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
    # the port's K1 and K2 kernels in the step, whatever their rank
    ours = [e for e in events
            if any(k in e.key for k in ("msda_", "deform_conv_", "scan_kernel"))]
    emit({"phase": "train_breakdown", "stages_ms": stages,
          "profiled_step_ms": span_ms, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / span_ms,
          "top_device_ms": [[e.key[:60], dev_us(e) / 1e3, e.count]
                            for e in top],
          "k1_k2_device_ms": [[e.key[:60], dev_us(e) / 1e3, e.count]
                              for e in sorted(ours, key=dev_us, reverse=True)]})
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
    want_plain = dict.fromkeys(counts["plain"], 0)
    want_kernels = {**want_plain, **STEP_LAUNCHES}
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
    ref = final_layer(engine, batch)
    del engine
    torch.cuda.empty_cache()
    int8_launches = phase_serve_int8(sd, batch, ref)
    torch.cuda.empty_cache()
    phase_plain(cfg, sd)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work_dir:
        trainer, batch, train_launches = phase_train(cfg, sd, work_dir)
        phase_train_breakdown(trainer, batch)
        del trainer
    torch.cuda.empty_cache()
    phase_train_plain(cfg, sd)
    torch.cuda.empty_cache()
    lidar_sd = lidar_state_dict()
    lidar_engine, clouds, lidar_launches = phase_lidar(lidar_sd)
    iou_launches = phase_iou(lidar_engine, clouds[0])
    del lidar_engine
    torch.cuda.empty_cache()
    phase_lidar_plain(lidar_sd, clouds[0])

    table = []
    for name, src, replaces, launches, covers in (
        ("msda_forward", "graph_detr4d_tpu_torch/csrc/msda.cu",
         "graph_detr4d_tpu/ops/msda.py:374", serve_launches,
         "one request's calls, bf16"),
        ("deform_conv_forward", "graph_detr4d_tpu_torch/csrc/deform_conv.cu",
         "graph_detr4d_tpu/ops/deform_conv.py:78", serve_launches,
         "one request's 9 calls, bf16 (sampling and contraction)"),
        ("msda_backward", "graph_detr4d_tpu_torch/csrc/msda.cu",
         "graph_detr4d_tpu/ops/msda.py:374", train_launches,
         "one train step's calls, bf16"),
        ("deform_conv_backward", "graph_detr4d_tpu_torch/csrc/deform_conv.cu",
         "graph_detr4d_tpu/ops/deform_conv.py:78", train_launches,
         "one train step's 9 calls, bf16 (x, offset, mask and weight "
         "gradients)"),
        ("focal_loss", "graph_detr4d_tpu_torch/csrc/focal_loss.cu",
         "graph_detr4d_tpu/ops/focal_loss.py:14", train_launches,
         "one train step's call, fp32"),
        ("hungarian", "graph_detr4d_tpu_torch/csrc/hungarian.cu",
         "graph_detr4d_tpu/ops/hungarian.py:95", train_launches,
         "one train step's call (6 layers x 128 x 900)"),
        ("deform_conv_int8_forward",
         "graph_detr4d_tpu_torch/csrc/deform_conv_int8.cu",
         "graph_detr4d_tpu/ops/deform_conv.py:259", int8_launches,
         "one int8 request's 7 calls, bf16 (amax, quantize, sampling and "
         "contraction)"),
        ("pillar_features", "graph_detr4d_tpu_torch/csrc/voxelize.cu",
         "graph_detr4d_tpu/ops/voxelize.py:26", lidar_launches,
         "one lidar request's call (pillar_indices + pillar_center_offsets,"
         " voxelize.py:26,77), 300,000 points"),
        ("pillar_scatter", "graph_detr4d_tpu_torch/csrc/voxelize.cu",
         "graph_detr4d_tpu/ops/voxelize.py:52", lidar_launches,
         "one lidar request's call, 300,000 points x 64 channels"),
        ("iou3d", "graph_detr4d_tpu_torch/csrc/iou3d.cu",
         "graph_detr4d_tpu/core/iou3d.py:159", iou_launches,
         "the iou phase's 2 calls, 900 x 900 and 300 x 128"),
    ):
        k = kernels[name]
        if "max_abs_err" in k:
            err = k["max_abs_err"]
        else:
            err = max(v[0] for c, v in k["checks"].items()
                      if c.endswith("float32") and isinstance(v, tuple))
        row = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "train_launches": train_launches[name],
            "max_abs_err": err, "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k.get("library_ms"), "ms_covers": covers,
        }
        if "gemm_ref_ms" in k:  # not the same function: no library_ms
            row["gemm_ref_ms"] = k["gemm_ref_ms"]
        if "clustered" in k:
            row["clustered_ms"] = k["clustered"]["ms"]
            row["clustered_bound_ms"] = k["clustered"]["bound_ms"]
        table.append(row)
    print(smi, flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
