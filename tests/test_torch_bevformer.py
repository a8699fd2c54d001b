"""BEVFormer-base (`bevformer_base`) on the serving path, on the CPU at tiny
widths with its 6 encoder and 6 decoder layers kept (a 16 x 16 BEV, width
32, 2 cameras):

  * the registry entry has the published shapes, and every other entry
    is what it was: the JAX registry's, and each benchmark configuration
    file's model;
  * the port's model against the benchmark's plain float32 reference
    (benchmark/reference/bevformer.py, loaded by its path): the BEV and
    every decoder layer's class logits and box codes over a 3-frame
    stream with a non-zero shift and rotation, and the reference's
    float8 control away from both; the caffe-style ResNet against the
    reference's;
  * Engine.infer_stream keeps the stream's BEV and pose, reads them on
    the stream's next request and turns the absolute can_bus into the
    frame's motion; it gives the span `model.head.bev_encoder` once a
    request and `model.head.bev_sca` once an encoder layer inside
    `model.head`, and records nothing with tracing off;
  * the counters `bev_sca_rows` and `bev_sca_overflow`;
  * the head's eval forward after a signature's first call makes no
    host copy (`torch.tensor`) and reads no value on the host, so CUDA
    graphs can capture it (models/k1_graph.py; the capture and the
    replay are held to the eager head on the card by
    tests/test_torch_cuda.py), and its `steps` launches K1 only at its
    yields, in order with its spans' eager stretches;
  * the reference loads nothing of the port and no JAX.
"""

import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from graph_detr4d_tpu import configs as jax_configs
from graph_detr4d_tpu_torch import config as port_config
from graph_detr4d_tpu_torch import configs as port_configs
from graph_detr4d_tpu_torch import tracing
from graph_detr4d_tpu_torch.models.bevformer import (CAN_YAW_DEG,
                                                     CAN_YAW_RAD)
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D
from graph_detr4d_tpu_torch.models.k1_graph import Eager
from graph_detr4d_tpu_torch.models.resnet import ResNet
from graph_detr4d_tpu_torch.ops import msda as msda_ops
from graph_detr4d_tpu_torch.serve import Engine
from test_torch_head_graph import SYNCS, _refuse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
NAME = "bevformer_base"
TINY = ["img_size=(64,160)", "head.num_query=24", "head.embed_dims=32",
        "head.num_heads=4", "head.ffn_dims=64", "head.num_cams=2",
        "head.num_frame_cams=2", "neck.out_channels=32", "coder.max_num=12",
        "bev.bev_h=16", "bev.bev_w=16", "bev.sca_capacity=128", "bf16=False"]
SEED = 2 ** 31 + 25
# float32 on both sides: the port's plain K1 sums in float64, the
# reference's corners in float32, and their convolutions and linears
# accumulate in other orders; through 6 encoder layers of 2 deformable
# attentions, 3 frames of the recurrence and 6 decoder layers that rounds
# to a few 1e-6 (1e-5 of margin). The float8 control reads 1e-2 and more.
FP32_TOL = 5e-5


def load_by_path(name, path, package_dir=None):
    spec = importlib.util.spec_from_file_location(
        name, path, submodule_search_locations=package_dir and [package_dir])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def rel(a, b):
    return float(torch.linalg.vector_norm(a.float() - b.float())
                 / torch.linalg.vector_norm(b.float()))


@pytest.fixture(scope="module")
def bench():
    """The benchmark's reference package, its seeded weights and its rig
    generator, each loaded from its file."""
    ref_dir = os.path.join(BENCH, "reference")
    load_by_path("bev_bench_reference", os.path.join(ref_dir, "__init__.py"),
                 ref_dir)
    return {
        "bev": importlib.import_module("bev_bench_reference.bevformer"),
        "common": importlib.import_module("bev_bench_reference.common"),
        "weights": load_by_path("bev_bench_weights",
                                os.path.join(BENCH, "harness", "weights.py")),
        "traffic": load_by_path("bev_bench_traffic",
                                os.path.join(BENCH, "harness", "traffic.py")),
    }


@pytest.fixture(scope="module")
def setup(bench):
    """The tiny config, its dict, reference-seeded weights, one frame and
    its rig."""
    cfg = port_configs.get_config(NAME, TINY)
    model = json.loads(json.dumps(dataclasses.asdict(cfg)))
    sd = bench["weights"].make_state_dict(bench["bev"].param_specs(model), SEED,
                                          "cpu")
    h = model["head"]
    H, W = model["img_size"]
    g = torch.Generator().manual_seed(5)
    images = torch.randn(1, h["num_cams"], H, W, 3, generator=g) * 0.5
    l2i = torch.as_tensor(bench["traffic"].surround_rig(
        h["num_cams"], h["num_frame_cams"], (H, W), np.random.default_rng(5)))[None]
    return cfg, model, sd, images, l2i


def motion(frame):
    """(1, 18) can_bus motion of a stream's frame: zero at the first, a
    translation and a yaw change after it."""
    can = torch.zeros(1, 18)
    if frame:
        can[0, :3] = torch.tensor([2.5 * frame, -1.2, 0.0])
        can[0, CAN_YAW_RAD] = 0.4 * frame
        can[0, CAN_YAW_DEG] = 6.0 * frame
    return can


def test_registry_entry_has_the_published_shapes():
    cfg = port_configs.get_config(NAME)
    h, bev, b, n = cfg.head, cfg.bev, cfg.backbone, cfg.neck
    assert isinstance(cfg, port_config.BEVFormerConfig)
    assert (cfg.head_type, cfg.img_size, cfg.img_mean, cfg.img_std,
            cfg.resnet_style) == ("bevformer", (928, 1600),
                                  (103.53, 116.28, 123.675), (1.0, 1.0, 1.0),
                                  "caffe")
    assert (b.depth, b.frozen_stages, b.out_indices, b.stage_with_dcn) == (
        101, 1, (1, 2, 3), (False, False, True, True))
    assert (n.in_channels, n.out_channels, n.start_level, n.num_outs,
            n.relu_before_extra_convs) == ((512, 1024, 2048), 256, 0, 4, True)
    assert (h.num_cams, h.embed_dims, h.num_heads, h.ffn_dims, h.num_query,
            h.num_decoder_layers, h.num_levels, h.num_points) == (
        6, 256, 8, 512, 900, 6, 4, 4)
    assert (bev.bev_h, bev.bev_w, bev.num_encoder_layers,
            bev.num_points_in_pillar, bev.sca_num_points,
            bev.tsa_num_points) == (200, 200, 6, 4, 8, 4)
    assert h.pc_range == (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    assert cfg.coder.max_num == 300
    assert cfg.coder.post_center_range == (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)
    # apply_overrides reaches the subclass's own group
    tiny = port_configs.get_config(NAME, ["bev.bev_h=16"])
    assert isinstance(tiny, port_config.BEVFormerConfig) and tiny.bev.bev_h == 16


def test_existing_registry_entries_are_unchanged():
    assert port_configs.PORT_ONLY == (NAME,)
    shared = [n for n in port_configs.list_configs() if n not in port_configs.PORT_ONLY]
    assert shared == jax_configs.list_configs()
    for name in shared:
        cfg = port_configs.get_config(name)
        assert type(cfg) is port_config.ModelConfig, name
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jax_configs.get_config(name)), name
    for f in ("flagship", "petrv2", "mp"):
        with open(os.path.join(BENCH, "configs", f + ".json")) as fh:
            c = json.load(fh)
        cfg = port_configs.get_config(c["port_config"], c.get("overrides", []))
        assert json.loads(json.dumps(dataclasses.asdict(cfg))) == c["model"], f


def test_program_matches_the_reference_over_a_stream(bench, setup):
    cfg, model, sd, images, l2i = setup
    program = GraphDETR4D(cfg, device="cpu")
    program.load_state_dict(sd, strict=True)  # param_specs names every tensor
    program.eval()
    ref_mod, common = bench["bev"], bench["common"]
    ref = common.Ref(sd, "fp32")
    low = common.Ref(sd, "fp8")
    with torch.no_grad():
        feats = program.extract_feats(images)
        ref_feats = ref_mod.features(ref, model, images)
        low_feats = ref_mod.features(low, model, images)
        for a, b in zip(feats, ref_feats):
            assert rel(a, b) < FP32_TOL
        prev = prev_ref = prev_low = None
        for frame in range(3):
            can = motion(frame)
            out = program.pts_bbox_head(feats, l2i, can, prev)
            bev, cls, box = ref_mod.bev_forward(ref, model, ref_feats, l2i, can,
                                                prev_ref)
            bev8, cls8, box8 = ref_mod.bev_forward(low, model, low_feats, l2i,
                                                   can, prev_low)
            assert rel(out["bev_embed"], bev) < FP32_TOL, frame
            assert cls.shape[0] == box.shape[0] == 6
            for l in range(6):
                assert rel(out["all_cls_scores"][l], cls[l]) < FP32_TOL, (frame, l)
                assert rel(out["all_bbox_preds"][l], box[l]) < FP32_TOL, (frame, l)
            # the control: the float8 reference, away from both
            for a, b in ((bev8, bev), (bev8, out["bev_embed"]), (cls8, cls),
                         (box8, box)):
                assert rel(a, b) >= 1e-3, frame
            assert float(out["cam_overflow"]) == 0.0
            prev, prev_ref, prev_low = out["bev_embed"], bev, bev8


def test_shift_and_rotation_move_the_bev(bench, setup):
    """The recurrence reads the motion: the same previous BEV with the
    motion of frame 1 and with none give other BEVs, on both sides."""
    cfg, model, sd, images, l2i = setup
    program = GraphDETR4D(cfg, device="cpu")
    program.load_state_dict(sd, strict=True)
    program.eval()
    with torch.no_grad():
        feats = program.extract_feats(images)
        prev = program.pts_bbox_head(feats, l2i, motion(0), None)["bev_embed"]
        still = motion(1)
        still[0, :3] = 0.0
        still[0, CAN_YAW_DEG] = 0.0
        moved = program.pts_bbox_head(feats, l2i, motion(1), prev)["bev_embed"]
        kept = program.pts_bbox_head(feats, l2i, still, prev)["bev_embed"]
    assert rel(moved, kept) > 1e-2


def test_caffe_resnet_matches_the_reference(bench, setup):
    """ResNet-101 in the caffe style (the stride on each stage's first
    1x1 conv, DCN at stride 1) against the reference's."""
    _, model, sd, images, _ = setup
    b = model["backbone"]
    net = ResNet(depth=b["depth"], out_indices=b["out_indices"],
                 stage_with_dcn=b["stage_with_dcn"], use_dcn=True, style="caffe")
    net.load_state_dict({k[len("img_backbone."):]: v for k, v in sd.items()
                         if k.startswith("img_backbone.")}, strict=True)
    net.eval()
    x = images[0]
    with torch.no_grad():
        got = net(x.permute(0, 3, 1, 2))
        want = bench["bev"].resnet_caffe(bench["common"].Ref(sd), x,
                                         "img_backbone.", b)
    assert [g.shape[-1] for g in got] == [20, 10, 5]  # strides 8, 16, 32
    for g, w in zip(got, want):
        assert rel(g.permute(0, 2, 3, 1), w) < FP32_TOL
    # the pytorch style's first 1x1 convs run at stride 1
    assert net.layer2[0].conv1.stride == (2, 2)
    assert net.layer2[0].conv2.stride == (1, 1)
    assert net.layer3[0].conv2.stride == 1  # DCN
    assert ResNet(depth=50, style="pytorch").layer2[0].conv1.stride == (1, 1)
    with pytest.raises(ValueError):
        ResNet(depth=50, style="other")


@pytest.fixture(scope="module")
def engine(setup):
    cfg, _, sd, _, _ = setup
    tracing.drain()
    return Engine(cfg, sd, device="cpu")


def stream_request(engine, seed=0, frame=0):
    h = engine.cfg.head
    H, W = engine.cfg.img_size
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 0.5, (1, h.num_cams, H, W, 3)).astype(np.float32)
    l2i = np.tile(np.eye(4, dtype=np.float32), (1, h.num_cams, 1, 1))
    can = np.zeros((1, 18), np.float32)
    can[0, :3] = [1000.0 + 3.0 * frame, 500.0 - frame, 0.0]
    can[0, CAN_YAW_DEG] = 350.0 + 4.0 * frame
    can[0, CAN_YAW_RAD] = np.deg2rad(can[0, CAN_YAW_DEG])
    return images, l2i, [can]


def test_infer_stream_caches_the_bev_and_pose(engine):
    seen = []
    head = engine.model.pts_bbox_head
    hook = head.register_forward_hook(
        lambda m, args, out: seen.append((args, out)))
    try:
        before = engine.counters()
        for frame in range(2):
            engine.infer_stream(*stream_request(engine, frame=frame),
                                stream="cache")
        after = engine.counters()
    finally:
        hook.remove()
    assert after["stream_misses"] - before["stream_misses"] == 1
    assert after["stream_hits"] - before["stream_hits"] == 1
    (args0, out0), (args1, _) = seen
    feats, l2i, can0, prev0 = args0
    assert prev0 is None
    assert torch.equal(can0[0, :3], torch.zeros(3)) and float(can0[0, CAN_YAW_DEG]) == 0.0
    _, _, can1, prev1 = args1
    assert prev1 is out0["bev_embed"]  # the cached BEV, not a copy
    assert torch.allclose(can1[0, :3], torch.tensor([3.0, -1.0, 0.0]))
    assert float(can1[0, CAN_YAW_DEG]) == pytest.approx(4.0)
    # the absolute yaw in radians passes through
    assert float(can1[0, CAN_YAW_RAD]) == pytest.approx(np.deg2rad(354.0), rel=1e-6)
    assert engine.reset_stream("cache")


def test_infer_stream_spans_each_layer_inside_the_head(engine):
    request = stream_request(engine)
    tracing.drain()
    engine.infer_stream(*request, stream="off")
    assert tracing.drain() == []
    tracing.enable()
    try:
        engine.infer_stream(*request, stream="on")
        engine.infer_stream(*request, stream="on")
    finally:
        tracing.disable()
    records = tracing.drain()
    heads = [r for r in records if r.name == "model.head"]
    encoders = [r for r in records if r.name == "model.head.bev_encoder"]
    scas = [r for r in records if r.name == "model.head.bev_sca"]
    assert len(heads) == len(encoders) == 2
    assert len(scas) == 2 * 6
    for r in encoders + scas:
        assert any(h.start_ns <= r.start_ns <= r.end_ns <= h.end_ns
                   for h in heads)
    for r in scas:
        assert any(e.start_ns <= r.start_ns <= r.end_ns <= e.end_ns
                   for e in encoders)


def test_counters_count_sca_rows_and_dropped_queries(setup):
    cfg, _, sd, _, rig = setup
    for capacity, dropped in ((128, False), (8, True)):
        c = dataclasses.replace(cfg, bev=dataclasses.replace(cfg.bev,
                                                             sca_capacity=capacity))
        eng = Engine(c, sd, device="cpu")
        images, _, can = stream_request(eng)
        l2i = rig.numpy()
        before = eng.counters()
        answers = [eng.infer_stream(images, l2i, can, stream="n") for _ in range(3)]
        after = eng.counters()
        assert (after["bev_sca_rows"] - before["bev_sca_rows"]
                == 3 * 6 * c.head.num_cams * capacity)
        dropped_now = after["bev_sca_overflow"] - before["bev_sca_overflow"]
        assert dropped_now == sum(a["cam_overflow"] for a in answers)
        assert (dropped_now > 0) == dropped, capacity


@pytest.fixture(scope="module")
def head_inputs(setup):
    """The tiny program in eval mode and one frame's features."""
    cfg, _, sd, images, l2i = setup
    program = GraphDETR4D(cfg, device="cpu")
    program.load_state_dict(sd, strict=True)
    program.eval()
    with torch.no_grad():
        feats = program.extract_feats(images)
    return program.pts_bbox_head, feats, l2i


def test_head_forward_after_the_first_makes_no_host_copy(head_inputs,
                                                         monkeypatch):
    """Both signatures of the head, a scene's first frame (no previous
    BEV) and a frame with one, each called once to make the device
    constants, then again with torch.tensor counted and the Tensor
    methods that read a value on the host patched to raise: no
    torch.tensor call (the decoder's, TSA's and SCA's (W, H) are
    device constants), the same outputs as the unpatched calls, and
    `bev_sca_overflow` summing each call's `cam_overflow` as before."""
    head, feats, l2i = head_inputs
    cans = [motion(0), motion(1)]
    with torch.inference_mode():
        first = head(feats, l2i, cans[0], None)
        want = head(feats, l2i, cans[1], first["bev_embed"])
        before = head.bev_sca_overflow
        calls = []
        tensor = torch.tensor

        def counted(*args, **kwargs):
            calls.append((args, kwargs))
            return tensor(*args, **kwargs)

        with monkeypatch.context() as patched:
            patched.setattr(torch, "tensor", counted)
            for name in SYNCS:
                patched.setattr(torch.Tensor, name, _refuse(name))
            got0 = head(feats, l2i, cans[0], None)
            got1 = head(feats, l2i, cans[1], got0["bev_embed"])
    assert calls == []
    for got, ref in ((got0, first), (got1, want)):
        assert got.keys() == ref.keys()
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
    assert head.bev_sca_overflow - before == float(
        got0["cam_overflow"] + got1["cam_overflow"])


def test_head_steps_launch_k1_only_at_their_yields(head_inputs, monkeypatch):
    """head.steps yields the encoder span's opening, then a layer TSA's
    K1 call and SCA's inside its span's opening and closing, then the
    encoder span's closing and the decoder's 6 K1 calls; driven by hand
    with msda_ops.msda_forward patched to raise, each eager stretch run
    at its yield, it gives forward's outputs bit for bit, counts
    cameras x capacity SCA rows a layer and records the spans nested
    as forward's."""
    head, feats, l2i = head_inputs
    can = motion(1)
    layers = head.cfg.bev.num_encoder_layers
    rows = head.cfg.head.num_cams * head.cfg.bev.sca_capacity

    def sca_rows():
        return sum(getattr(m, "bev_sca_rows", 0) for m in head.modules())

    with torch.no_grad():
        prev = head(feats, l2i, motion(0), None)["bev_embed"]
        want = head(feats, l2i, can, prev)
        k1 = msda_ops.msda_forward
        monkeypatch.setattr(msda_ops, "msda_forward", _refuse("K1 launch"))
        steps = head.steps(list(feats), l2i, can, prev)
        order, sent, counted = [], None, sca_rows()
        tracing.drain()
        tracing.enable()
        try:
            while True:
                try:
                    step = steps.send(sent)
                except StopIteration as done:
                    got = done.value
                    break
                if isinstance(step, Eager):
                    order.append(step.fn.__name__)
                    sent = step.fn(*step.args)
                else:
                    order.append("k1")
                    assert len(step) == 5
                    sent = k1(*step)
        finally:
            tracing.disable()
    assert order == (["open_encoder"]
                     + layers * ["k1", "open_span", "k1", "close_span"]
                     + ["close_encoder"]
                     + head.cfg.head.num_decoder_layers * ["k1"])
    assert sca_rows() - counted == layers * rows
    spans = tracing.drain()
    assert [r.name for r in spans] == (layers * ["model.head.bev_sca"]
                                       + ["model.head.bev_encoder"])
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_reference_loads_nothing_of_the_port_and_no_jax():
    code = (
        "import importlib, importlib.util, json, sys\n"
        f"d = {os.path.join(BENCH, 'reference')!r}\n"
        "spec = importlib.util.spec_from_file_location(\n"
        "    'ref', d + '/__init__.py', submodule_search_locations=[d])\n"
        "m = importlib.util.module_from_spec(spec); sys.modules['ref'] = m\n"
        "spec.loader.exec_module(m)\n"
        "importlib.import_module('ref.bevformer')\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=BENCH)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "torch" in loaded
    assert not [m for m in loaded
                if m.startswith("graph_detr4d_tpu") or m in ("jax", "jaxlib", "flax")]
