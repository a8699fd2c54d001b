"""The per-layer metrics' instruments and readers; each metric file under
`metrics/` binds one of these to its name."""

import numpy as np

from flops.bounds import PEAK_BF16_TENSOR_FLOPS, dcn_bound_ms, msda_bound_ms
from harness.instruments import (ShapeOf, mean_ms_per_request, time_modules,
                                 wrap_entry)

K1_RANGE, K2_RANGE = "bench::k1_fwd", "bench::k2_fwd"


def h2d_ms(run):
    """Device ms a request of the host-to-device copies (serve.Engine's
    copy of the numpy inputs), from the profile."""
    s = run.trace.device_s(lambda name: "HtoD" in name)
    return 1e3 * s / run.traced_requests if s > 0 else None


def install_backbone(run):
    """CUDA events from the start of `img_backbone` to the end of
    `img_neck`, by forward hooks."""
    if run.device.type == "cuda":
        time_modules(run, "backbone", run.model.img_backbone, run.model.img_neck)


def backbone_ms(run):
    return mean_ms_per_request(run, "backbone")


def install_head(run):
    """CUDA events around `pts_bbox_head`, by forward hooks."""
    if run.device.type == "cuda":
        head = run.model.pts_bbox_head
        time_modules(run, "head", head, head)


def head_ms(run):
    return mean_ms_per_request(run, "head")


def install_k1(run):
    """Every call of ops.msda.msda_forward inside a host range; each
    call's arguments kept for its bound (the value's shape only)."""
    calls = run.state.setdefault("k1_fwd", [])

    def keep(value, spatial_shapes, loc, attn, index=None):
        calls.append((ShapeOf(value), loc, attn, index,
                      [tuple(s) for s in spatial_shapes]))

    wrap_entry(run, "graph_detr4d_tpu_torch.ops.msda", "msda_forward", K1_RANGE,
               keep)


def k1_fwd_roofline(run):
    """%: the sum of msda_bound_ms over the calls, over the device time of
    every kernel launched inside them."""
    device_s, ranges = run.trace.in_ranges_s(K1_RANGE)
    calls = run.state.get("k1_fwd")
    if not ranges or device_s <= 0 or not calls:
        return None
    return 100.0 * sum(msda_bound_ms(*c) for c in calls) / (1e3 * device_s)


def install_k2(run):
    """Every call of ops.deform_conv.deform_conv inside a host range, its
    dcn_bound_ms worked out from its arguments."""
    bounds = run.state.setdefault("k2_fwd", [])

    def keep(x, offsets, mask, w, *args, **kwargs):
        bounds.append(dcn_bound_ms(x, offsets, w))

    wrap_entry(run, "graph_detr4d_tpu_torch.ops.deform_conv", "deform_conv",
               K2_RANGE, keep)


def k2_fwd_roofline(run):
    device_s, ranges = run.trace.in_ranges_s(K2_RANGE)
    bounds = run.state.get("k2_fwd")
    if not ranges or device_s <= 0 or not bounds:
        return None
    return 100.0 * sum(bounds) / (1e3 * device_s)


def mfu(run):
    """%: the model FLOPs of the measured window's requests (cells/
    <workload>.json, counted on the reference) over the seconds they were
    being served, as a share of the dense bfloat16 peak."""
    if run.device.type != "cuda" or run.service_s <= 0:
        return None
    flops = run.cell["flops_per_request"] * run.requests
    return 100.0 * flops / run.service_s / PEAK_BF16_TENSOR_FLOPS


def device_idle(run):
    """%: 100 (1 - busy / window) of the profiled requests, busy the
    union of the device events' intervals."""
    busy = run.trace.busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / run.trace.window_s)


def service_ms_p95(run):
    """The 95th percentile of the measured window's service times, ms."""
    if not run.service:
        return None
    return 1e3 * float(np.percentile(np.asarray(run.service), 95))
