"""The MP configuration and its cell `mp_stream` on the CPU at tiny widths:
the reference against the program's plain route in float32 and its
float8 control away from both; the harness finds the configuration, the
cell and its FLOPs, the neighbour branch's K1 samples among them; a sound
traced run comes out correct, and the float8 control and a planted wrong
graph do not; the rows drivers/serve_mp.py sets aside; the cell's two
metric files read nothing where there is nothing to read."""

from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

import reference
from flops.count import request_flops
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D
from harness.cell import Run, load_json, load_metric, run_cell
from harness.check import rel
from harness.traffic import surround_rig
from harness.weights import make_state_dict
from reference.common import Ref
from tiny import BENCH_DIR, TINY, bench, config, tiny_model

SEED = 2 ** 31 + 4243
METRICS = ["mp_graph_ms.serve", "mp_neighbour_ms.serve"]


def test_reference_matches_the_program_in_float32():
    cfg, model = tiny_model("mp", ["bf16=False"])
    ref_mod = reference.load(config("mp")["reference"])
    sd = make_state_dict(ref_mod.param_specs(model), SEED, "cpu")
    program = GraphDETR4D(cfg, device="cpu")
    program.load_state_dict(sd, strict=True)
    program.eval()
    h = model["head"]
    H, W = model["img_size"]
    g = torch.Generator().manual_seed(12)
    images = torch.randn(1, h["num_cams"], H, W, 3, generator=g) * 0.5
    l2i = torch.as_tensor(surround_rig(h["num_cams"], h["num_frame_cams"], (H, W),
                                       np.random.default_rng(4)))[None]
    with torch.no_grad():
        out = program(images, l2i)
        for precision, low, high in (("fp32", 0.0, 1e-5), ("fp8", 1e-3, 1.0)):
            ref = Ref(sd, precision)
            cls, box = ref_mod.forward_feats(
                ref, model, ref_mod.features(ref, model, images), l2i, {})
            for layer in range(h["num_decoder_layers"]):
                assert low <= rel(out["all_cls_scores"][layer], cls[layer]) <= high
                assert low <= rel(out["all_bbox_preds"][layer], box[layer]) <= high


def test_harness_finds_the_configuration_the_cell_and_its_flops():
    run = Run(bench(), "mp_stream", SEED, "cpu")  # the file's model is the registry's
    assert run.config["name"] == "mp" and run.config["reduced"] == []
    assert run.cfg.head.attn_type == "deform3d_mp"
    assert run.traffic_spec["entry"] == "infer_stream"
    assert run.driver.__name__ == "drivers.serve_mp"
    h = run.model_dict["head"]
    assert (h["num_cams"], h["num_query"], h["num_decoder_layers"], h["num_heads"],
            h["num_levels"], h["num_points"], h["num_neighbors"], h["embed_dims"],
            h["ffn_dims"], run.model_dict["img_size"], run.model_dict["bf16"]) == (
        12, 900, 6, 8, 4, 4, 8, 256, 512, [640, 1600], True)
    assert run.cell["flops_per_request"] == request_flops(run.config, "infer_stream")


def test_neighbour_samples_count_by_k1s_formula():
    """The reference's neighbour sampling is one product a (row, head),
    which FlopCounterMode counts at K1's 2 hd FLOPs a corner; at the
    published widths 6 x 12 x 7,200 x 8 x 4 x 1 x 4 x 2 x 32 FLOPs a
    request, the samples count.py's `k1_flops` leaves out."""
    from torch.utils.flop_counter import FlopCounterMode

    mp = reference.load("mp")
    BN, R, nh, hd, L, P = 3, 10, 4, 8, 2, 1
    shapes = [(6, 8), (3, 4)]
    value = torch.empty(BN, sum(h * w for h, w in shapes), nh, hd, device="meta")
    loc = torch.empty(BN, R, nh, L, P, 2, device="meta")
    attn = torch.empty(BN, R, nh, L, P, device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        mp.msda_corners(value, shapes, loc, attn)
    assert counter.get_total_flops() == BN * R * nh * L * P * 4 * 2 * hd
    full = request_flops(config("mp"), "infer_stream")
    assert full - request_flops(config("flagship"), "infer_stream") > 6 * 12 * 7200 * 8 * 4 * 4 * 2 * 32


def test_corner_product_is_flagships_sampling():
    mp = reference.load("mp")
    g = torch.Generator().manual_seed(3)
    shapes = [(6, 8), (3, 4)]
    value = torch.randn(2, 60, 4, 8, generator=g)
    loc = torch.rand(2, 10, 4, 2, 3, 2, generator=g) * 1.2 - 0.1  # some outside
    attn = torch.rand(2, 10, 4, 2, 3, generator=g)
    want = mp.msda(value, shapes, loc, attn)
    assert torch.allclose(mp.msda_corners(value, shapes, loc, attn), want,
                          rtol=1e-6, atol=1e-6)


def test_sound_traced_run_is_correct():
    result, lines = run_cell(bench(), "mp_stream", SEED, 1.0, 1, "cpu", overrides=TINY)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["config"]["name"] == "mp"
    assert lines[-1].startswith("check ")
    # no device on the CPU: the spans have no CUDA events, K1 no device time
    assert not set(METRICS) & set(result["metrics"])


def test_float8_control_is_not_correct():
    from control_mp import control_numbers

    # 40 requests, the feature window: the sample's head inputs are compared
    numbers = control_numbers(bench(), "mp_stream", SEED, 40, "cpu", TINY)
    limits = load_json(BENCH_DIR, "cells", "mp_stream.json")["limits"]
    assert any(numbers[k] > limits[k] for k in ("features", "logits", "boxes")), numbers


@pytest.mark.parametrize("name", METRICS)
def test_metric_reads_none_with_nothing_to_read(name):
    metric = load_metric(name)
    empty = NS(state={}, trace=NS(in_ranges_s=lambda name: (0.0, [])),
               traced_requests=0, device=torch.device("cpu"))
    assert metric.read(empty) is None


def farthest(ref, k):
    """A planted fault: each query's k farthest queries."""
    d2 = ((ref[:, :, None, :] - ref[:, None, :, :]) ** 2).sum(-1)
    return torch.topk(d2, k, dim=-1).indices


def test_planted_graph_fault_is_not_correct(monkeypatch):
    monkeypatch.setattr("graph_detr4d_tpu_torch.models.transformer.graph_neighbours",
                        farthest)
    result, _ = run_cell(bench(), "mp_stream", SEED, 1.0, 0, "cpu", overrides=TINY)
    assert not result["correct"]
    for number in ("logits", "boxes"):
        c = result["checks"][number]
        assert c["value"] > c["limit"], number


def line(Q, k):
    """(1, Q, 3) points on a line, q at q / Q, and their k-nearest graph."""
    pts = torch.zeros(1, Q, 3)
    pts[0, :, 0] = torch.arange(Q) / Q
    return pts, reference.load("mp").query_graph(pts, k)


def test_rows_set_aside_are_near_ties():
    from drivers.serve_mp import set_aside

    Q, k = 40, 2
    pts, want = line(Q, k)
    assert not set_aside(want, pts, want).any()
    assert not set_aside(want.flip(-1), pts, want).any()  # the order is free
    # row 10 takes 12 for 9 (d 4 / Q^2 against the reference's 1 / Q^2): kept
    far = want.clone()
    far[0, 10] = torch.tensor([11, 12])
    assert not set_aside(far, pts, want).any()
    # 12 at 1.05 / Q from row 10, behind 9 and 11 at 1 / Q: a near-tie
    tied = pts.clone()
    tied[0, 12, 0] = 11.05 / Q
    tied_graph = reference.load("mp").query_graph(tied, k)
    tie = tied_graph.clone()
    tie[0, 10] = torch.tensor([11, 12])
    assert set_aside(tie, tied, tied_graph)[0].nonzero().flatten().tolist() == [10]


def test_head_numbers_read_the_first_layer_and_its_guards():
    from drivers.serve_mp import GROSS, MAX_SET_ASIDE, head_numbers, set_aside

    Q, k = 40, 2
    pts, want = line(Q, k)
    g = torch.Generator().manual_seed(5)
    cls, box = torch.randn(2, 1, Q, 10, generator=g), torch.randn(2, 1, Q, 10, generator=g)
    kept = {0: (cls, box)}
    pcls, pbox = cls.clone(), box.clone()
    heads = {0: (pcls, pbox)}
    assert head_numbers(heads, {0: want}, kept, pts, want) == {"logits": 0.0,
                                                               "boxes": 0.0}
    pcls[0, 0, 7] += 0.5  # a kept row's logits in the first layer
    out = head_numbers(heads, {0: want}, kept, pts, want)
    assert out["logits"] == pytest.approx(rel(pcls[0, 0], cls[0, 0])) and out["boxes"] == 0
    # a later layer past its gross bound
    pbox[1] += 2 * GROSS["boxes"] * box[1].norm() / box[1].numel() ** 0.5
    assert head_numbers(heads, {0: want}, kept, pts, want)["boxes"] == 1.0
    pbox[1] = box[1]
    assert head_numbers(heads, {0: None}, kept, pts, want) == {"logits": 1.0,
                                                               "boxes": 1.0}
    # a square grid ties each point's 4 nearest: a graph of the points
    # moved by a hair picks other ties in most rows, each a near-tie
    grid = torch.zeros(1, Q, 3)
    grid[0, :, 0], grid[0, :, 1] = torch.arange(Q) % 8, torch.arange(Q) // 8
    hair = grid + 1e-4 * torch.randn(1, Q, 3, generator=g)
    mp = reference.load("mp")
    want, other = mp.query_graph(grid, k), mp.query_graph(hair, k)
    aside = set_aside(other, grid, want)
    assert float(aside.float().mean()) > MAX_SET_ASIDE
    assert head_numbers(heads, {0: other}, kept, grid, want) == {"logits": 1.0,
                                                                 "boxes": 1.0}
