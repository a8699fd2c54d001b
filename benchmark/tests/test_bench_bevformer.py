"""The BEVFormer configuration and its cell `bevformer_stream` on the CPU at
tiny widths (a 16 x 16 BEV, width 32, 2 cameras, float32): the harness
finds the configuration, the cell and its FLOPs; a sound run comes out
correct; each planted fault (no previous BEV, the rotation skipped, the
shift's sign flipped, one camera's SCA rows dropped) and the float8
control fail a number; the seeded ego path and images are what the
traffic file says; the cell's two metric files read nothing where there
is nothing to read."""

from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from flops.count import request_flops
from harness.cell import Run, load_json, load_metric, run_cell
from tiny import BENCH_DIR, bench, config

# a seed whose check sample has requests 4, 5 and 9 and whose feature
# sample has 4 and 9: a few seconds of tiny requests reach them
SEED = 2147483746
SECONDS = 3.0
TINY = ["img_size=(64,160)", "head.num_query=24", "head.embed_dims=32",
        "head.num_heads=4", "head.ffn_dims=64", "neck.out_channels=32",
        "coder.max_num=12", "bev.bev_h=16", "bev.bev_w=16",
        "bev.sca_capacity=128", "head.num_cams=2", "head.num_frame_cams=2",
        "bf16=False"]
METRICS = ["bev_encoder_ms.serve", "bev_sca_ms.serve"]
BEV = "graph_detr4d_tpu_torch.models.bevformer"


def limits():
    return load_json(BENCH_DIR, "cells", "bevformer_stream.json")["limits"]


def test_harness_finds_the_configuration_the_cell_and_its_flops():
    run = Run(bench(), "bevformer_stream", SEED, "cpu")  # the file's model is the registry's
    assert run.config["name"] == "bevformer" and run.config["reduced"] == []
    assert run.driver.__name__ == "drivers.serve_bev"
    assert run.traffic_spec["entry"] == "infer_stream"
    m = run.model_dict
    h, b = m["head"], m["bev"]
    assert (h["num_cams"], h["num_query"], h["num_decoder_layers"], h["embed_dims"],
            b["bev_h"], b["bev_w"], b["num_encoder_layers"], m["img_size"],
            m["resnet_style"], m["backbone"]["depth"], m["bf16"]) == (
        6, 900, 6, 256, 200, 200, 6, [928, 1600], "caffe", 101, True)
    assert run.cell["flops_per_request"] == request_flops(run.config, "infer_stream")


def no_previous_bev(monkeypatch):
    """The head never gets the stream's BEV."""
    from graph_detr4d_tpu_torch.models.bevformer import BEVFormerHead

    real = BEVFormerHead.forward
    monkeypatch.setattr(BEVFormerHead, "forward",
                        lambda self, f, l, can_bus=None, prev_bev=None:
                        real(self, f, l, can_bus, None))


def rotation_skipped(monkeypatch):
    monkeypatch.setattr(BEV + ".rotate_bev", lambda bev, angle, h, w: bev)


def shift_sign_flipped(monkeypatch):
    import graph_detr4d_tpu_torch.models.bevformer as bevformer

    real = bevformer.bev_shift
    monkeypatch.setattr(bevformer, "bev_shift", lambda *a: -real(*a))


def camera_rows_dropped(monkeypatch):
    """Camera 0's SCA rows sample, then count for nothing."""
    from graph_detr4d_tpu_torch.models.bevformer import SCARows

    real = SCARows.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        self.keep = self.keep.clone()
        self.keep[0] = 0.0

    monkeypatch.setattr(SCARows, "__init__", init)


def test_sound_traced_run_is_correct():
    result, lines = run_cell(bench(), "bevformer_stream", SEED, SECONDS, 1, "cpu",
                             overrides=TINY)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 9 and result["config"]["name"] == "bevformer"
    assert lines[-1].startswith("check ")
    assert result["checks"]["features"]["value"] > 0  # the sample was reached
    # no device on the CPU: the spans have no CUDA events
    assert not set(METRICS) & set(result["metrics"])


@pytest.mark.parametrize("fault", [no_previous_bev, rotation_skipped,
                                   shift_sign_flipped, camera_rows_dropped],
                         ids=lambda f: f.__name__)
def test_planted_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result, _ = run_cell(bench(), "bevformer_stream", SEED, SECONDS, 0, "cpu",
                         overrides=TINY)
    assert not result["correct"]
    failed = {k for k, c in result["checks"].items() if c["value"] > c["limit"]}
    # the BEV of a request read from the program's own previous one, and
    # the chain from the scene's first frame, both see it
    assert {"bev", "bev_chain"} <= failed, result["checks"]


def test_float8_control_is_not_correct():
    from control_bev import control_numbers

    numbers = control_numbers(bench(), "bevformer_stream", SEED, 10, "cpu", TINY)
    assert any(numbers[k] > v for k, v in limits().items()), numbers


def test_ego_path_and_images_are_the_traffic_files():
    from drivers.serve_bev import BEVTraffic, check_sample, ego_path

    spec = load_json(BENCH_DIR, "traffic", "stream_scenes_bev.json")
    path = ego_path(SEED, 0, 40, spec)
    step = np.hypot(*np.diff(path[:, :2].astype(np.float64), axis=0).T)
    assert step.max() <= spec["max_speed_mps"] * spec["keyframe_s"] + 1e-3
    assert step.max() > 0.5 * spec["max_speed_mps"] * spec["keyframe_s"]
    yaw = np.diff(np.unwrap(path[:, 16].astype(np.float64)))
    assert np.abs(yaw).max() <= spec["max_yaw_rate"] * spec["keyframe_s"] + 1e-5
    assert ((path[:, 17] >= 0) & (path[:, 17] < 360)).all()
    assert np.allclose(np.deg2rad(path[:, 17]), path[:, 16], atol=1e-5)
    model = dict(config("bevformer")["model"], img_size=[930, 8])
    t = BEVTraffic(dict(spec, pool_frames=2), model, SEED, "cpu")
    assert (t.frames[:, :, 900:] == 0).all() and (t.frames[:, :, :900] != 0).any()
    assert (t.motion(0)[0, [0, 1, 2, 17]] == 0).all()  # a scene's first frame
    want = path[5].astype(np.float64) - path[4]
    assert np.allclose(t.motion(5)[0, :3], want[:3], atol=1e-5)
    assert t.motion(5)[0, 17] == pytest.approx(want[17], abs=1e-4)
    assert t.motion(5)[0, 16] == path[5, 16]  # the absolute yaw passes
    picks = check_sample(spec, SEED)
    assert picks[0] == 0 and len(picks) == spec["check_requests"]
    assert max(picks) < spec["check_window"]


@pytest.mark.parametrize("name", METRICS)
def test_metric_reads_none_with_nothing_to_read(name):
    metric = load_metric(name)
    empty = NS(state={}, trace=NS(in_ranges_s=lambda name: (0.0, [])),
               traced_requests=0, device=torch.device("cpu"))
    assert metric.read(empty) is None
