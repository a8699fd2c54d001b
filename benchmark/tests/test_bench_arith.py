"""The benchmark's arithmetic on synthetic inputs: interval unions, the
frozen bound functions against golden values computed from their
originals (chip_smoke.py's msda_bound_ms and dcn_bound_ms), the closed
loop's window, and the FLOP formulas against
graph_detr4d_tpu_torch/tools/get_flops.py."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from flops import bounds
from flops.count import k1_flops
from graph_detr4d_tpu_torch.tools import get_flops
from harness.instruments import ShapeOf
from harness.trace import merged, union_us
from reference.common import Ref
from reference.flagship import deform_conv

LEVELS = [(8, 20), (4, 10)]


def k1_inputs():
    g = torch.Generator().manual_seed(7)
    BN, Q, nh, L, P, hd = 3, 16, 2, 2, 4, 8
    S = sum(h * w for h, w in LEVELS)
    value = torch.randn(BN, S, nh, hd, generator=g).bfloat16()
    loc = torch.rand(BN, Q, nh, L, P, 2, generator=g) * 1.2 - 0.1
    attn = torch.rand(BN, Q, nh, L, P, generator=g)
    attn[attn < 0.3] = 0
    index = torch.stack([torch.randperm(Q, generator=g)[:10] for _ in range(BN)])
    x = torch.randn(2, 9, 11, 16, generator=g).bfloat16()
    off = torch.randn(2, 5, 6, 9, 2, generator=g)
    w = torch.randn(9 * 16, 24, generator=g).bfloat16()
    return value, loc, attn, index, x, off, w


def test_union_counts_overlaps_once():
    iv = [(0, 10), (5, 15), (20, 25), (24, 30), (40, 41)]
    assert union_us(iv) == 26
    assert merged(iv) == [[0, 15], [20, 30], [40, 41]]
    assert union_us([]) == 0


def test_bounds_match_their_originals():
    # golden values of chip_smoke.py's functions on these inputs
    value, loc, attn, index, x, off, w = k1_inputs()
    assert bounds.msda_bound_ms(value, loc, attn, index, LEVELS) == pytest.approx(
        4.862089552238806e-06, rel=1e-12)
    assert bounds.msda_bound_ms(value, loc, attn, None, LEVELS) == pytest.approx(
        6.8632835820895525e-06, rel=1e-12)
    assert bounds.dcn_bound_ms(x, off, w) == pytest.approx(5.781492537313433e-06, rel=1e-12)
    assert bounds.dcn_bound_ms(x.float(), off, w.float()) == pytest.approx(
        1.1562985074626865e-05, rel=1e-12)


def test_bound_reads_only_the_value_shape():
    value, loc, attn, index, *_ = k1_inputs()
    assert bounds.msda_bound_ms(ShapeOf(value), loc, attn, index, LEVELS) == \
        bounds.msda_bound_ms(value, loc, attn, index, LEVELS)


def test_k1_formula_counts_every_corner_of_every_sample():
    # in-image samples with nonzero weights: get_flops' per-call count
    # then reaches every corner, as the reference-side formula assumes
    model = {"head_type": "detr4d_pe", "head": dict(
        num_cams=3, num_query=16, num_heads=2, num_levels=2, num_points=4,
        embed_dims=16, num_decoder_layers=1)}
    g = torch.Generator().manual_seed(3)
    value = torch.randn(3, sum(h * w for h, w in LEVELS), 2, 8, generator=g)
    loc = torch.rand(3, 16, 2, 2, 4, 2, generator=g) * 0.5 + 0.25
    attn = torch.rand(3, 16, 2, 2, 4, generator=g) + 0.1
    assert k1_flops(model) == get_flops.msda_operations(value, LEVELS, loc, attn)


def test_reference_dcn_counts_k2_formula():
    g = torch.Generator().manual_seed(5)
    sd = {"c.weight": torch.randn(24, 16, 3, 3, generator=g),
          "c.conv_offset.weight": torch.randn(27, 16, 3, 3, generator=g),
          "c.conv_offset.bias": torch.randn(27, generator=g)}
    x = torch.randn(2, 9, 11, 16, generator=g)
    counter = FlopCounterMode(display=False)
    with counter:
        y = deform_conv(Ref(sd), x, "c", 2)
    offsets_conv = 2 * 2 * 5 * 6 * 27 * 16 * 9  # the offset conv's taps
    assert counter.get_total_flops() - offsets_conv == get_flops.dcn_operations(
        x, torch.zeros(2, 5, 6, 9, 2), sd["c.weight"])
    assert y.shape == (2, 5, 6, 24)


def test_idle_gaps_go_to_the_innermost_host_operator():
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from harness.trace import Trace

    def ev(name, s, e, dev=DeviceType.CPU, thread=1):
        return NS(name=name, time_range=NS(start=s, end=e), device_type=dev,
                  thread=thread)

    t = Trace.__new__(Trace)
    t.t0, t.t1, t.thread = 0.0, 100.0, 1
    t.device = [ev("k1", 10, 20, DeviceType.CUDA), ev("k2", 50, 60, DeviceType.CUDA)]
    t.host = [ev("outer", 0, 100), ev("inner", 22, 40), ev("other thread", 0, 100, thread=2)]
    # gaps 0-10 (outer), 20-50 (mid 35: inner), 60-100 (outer)
    assert t.busy_s() == 20e-6
    assert t.idle_gaps() == [["outer", 50e-6], ["inner", 30e-6]]


def test_closed_loop_sends_back_to_back_and_keeps_all_the_time():
    import time as _time
    from types import SimpleNamespace as NS

    from harness.cell import closed_loop

    sent = []

    def send(run, i):
        sent.append(_time.perf_counter())
        _time.sleep(0.01 if i != 3 else 0.06)  # request 3 is slow

    run = NS(driver=NS(send=send))
    closed_loop(run, 0.3)
    assert run.requests == len(sent) == len(run.service)
    assert 15 <= run.requests <= 26  # 0.3 s of 10 ms units, one of 60
    assert sent[4] - sent[3] >= 0.06  # the next is sent when it is done
    assert run.service_s == sum(run.service)
    # the window runs until the last unit sent is done
    assert run.window_s >= 0.3 and run.window_s >= sent[-1] - sent[0]
