"""The MP configuration (detr4d_res50_deform_pe_mp_testaug_2subset_12e:
the multi-point graph cross-attention) on the serving path, on the CPU at
tiny widths with its 6 decoder layers kept:

  * the port's model against the benchmark's plain float32 reference
    (benchmark/reference/mp.py, loaded by its path) on every decoder
    layer's class logits and box codes, and the reference's float8
    control away from both;
  * Engine.infer_stream gives the spans `model.head.graph` and
    `model.head.neighbours` once a decoder layer, inside `model.head`,
    and records nothing with tracing off;
  * the counters `mp_graph_builds` and `mp_neighbour_rows` advance by
    one graph a layer and K x Q rows a layer;
  * the reference loads nothing of the port and no JAX.
"""

import importlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from graph_detr4d_tpu_torch import tracing
from graph_detr4d_tpu_torch.configs import get_config
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D
from graph_detr4d_tpu_torch.serve import Engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
NAME = "detr4d_res50_deform_pe_mp_testaug_2subset_12e"
TINY = ["img_size=(64,160)", "head.num_query=24", "head.embed_dims=64",
        "head.num_heads=4", "head.num_points=2", "head.ffn_dims=128",
        "head.depth_num=8", "head.pe_num_feats=32", "neck.out_channels=64",
        "coder.max_num=12", "bf16=False"]
SEED = 2 ** 31 + 21


def load_by_path(name, path, package_dir=None):
    spec = importlib.util.spec_from_file_location(
        name, path, submodule_search_locations=package_dir and [package_dir])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def bench():
    """The benchmark's reference package, its seeded weights and its rig
    generator, each loaded from its file."""
    ref_dir = os.path.join(BENCH, "reference")
    load_by_path("mp_bench_reference", os.path.join(ref_dir, "__init__.py"), ref_dir)
    return {
        "mp": importlib.import_module("mp_bench_reference.mp"),
        "common": importlib.import_module("mp_bench_reference.common"),
        "weights": load_by_path("mp_bench_weights",
                                os.path.join(BENCH, "harness", "weights.py")),
        "traffic": load_by_path("mp_bench_traffic",
                                os.path.join(BENCH, "harness", "traffic.py")),
    }


@pytest.fixture(scope="module")
def setup(bench):
    """The tiny config, its dict, reference-seeded weights and one rig."""
    import dataclasses

    cfg = get_config(NAME, TINY)
    model = json.loads(json.dumps(dataclasses.asdict(cfg)))
    sd = bench["weights"].make_state_dict(bench["mp"].param_specs(model), SEED, "cpu")
    h = model["head"]
    H, W = model["img_size"]
    g = torch.Generator().manual_seed(5)
    images = torch.randn(1, h["num_cams"], H, W, 3, generator=g) * 0.5
    l2i = torch.as_tensor(bench["traffic"].surround_rig(
        h["num_cams"], h["num_frame_cams"], (H, W), np.random.default_rng(5)))[None]
    return cfg, model, sd, images, l2i


def rel(a, b):
    return float(torch.linalg.vector_norm(a.float() - b.float())
                 / torch.linalg.vector_norm(b.float()))


def test_program_matches_the_reference_in_float32(bench, setup):
    cfg, model, sd, images, l2i = setup
    program = GraphDETR4D(cfg, device="cpu")
    program.load_state_dict(sd, strict=True)  # param_specs names every tensor
    program.eval()
    mp, common = bench["mp"], bench["common"]
    with torch.no_grad():
        out = program(images, l2i)
        want = {}
        for precision in ("fp32", "fp8"):
            ref = common.Ref(sd, precision)
            want[precision] = mp.forward_feats(
                ref, model, mp.features(ref, model, images), l2i, {})
    cls, box = want["fp32"]
    cls8, box8 = want["fp8"]
    layers = cfg.head.num_decoder_layers
    assert cls.shape[0] == box.shape[0] == layers == 6
    for l in range(layers):
        assert rel(out["all_cls_scores"][l], cls[l]) < 1e-5, l
        assert rel(out["all_bbox_preds"][l], box[l]) < 1e-5, l
    # the control: the float8 reference, away from the reference and the port
    for a, b in ((cls8, cls), (box8, box), (cls8, out["all_cls_scores"]),
                 (box8, out["all_bbox_preds"])):
        assert rel(a, b) >= 1e-3


@pytest.fixture(scope="module")
def engine(setup):
    cfg, _, sd, _, _ = setup
    tracing.drain()
    return Engine(cfg, sd, device="cpu")


def stream_request(engine, seed=0):
    h = engine.cfg.head
    H, W = engine.cfg.img_size
    rng = np.random.default_rng(seed)
    frame = rng.normal(0, 0.5, (1, h.num_frame_cams, H, W, 3)).astype(np.float32)
    l2i = np.tile(np.eye(4, dtype=np.float32), (1, h.num_cams, 1, 1))
    return frame, l2i


def test_infer_stream_spans_each_layer_inside_the_head(engine):
    frame, l2i = stream_request(engine)
    tracing.drain()
    engine.infer_stream(frame, l2i, stream="off")
    assert tracing.drain() == []
    tracing.enable()
    try:
        engine.infer_stream(frame, l2i, stream="on")
        engine.infer_stream(frame, l2i, stream="on")
    finally:
        tracing.disable()
    records = tracing.drain()
    heads = [r for r in records if r.name == "model.head"]
    assert len(heads) == 2
    for name in ("model.head.graph", "model.head.neighbours"):
        spans = [r for r in records if r.name == name]
        assert len(spans) == 2 * 6, name
        for r in spans:
            assert any(h.start_ns <= r.start_ns <= r.end_ns <= h.end_ns
                       for h in heads), name
    # a layer's graph comes before its neighbour branch
    inner = [r.name for r in records if r.name.startswith("model.head.")]
    assert inner == 12 * ["model.head.graph", "model.head.neighbours"]


def test_counters_advance_by_a_graph_and_kq_rows_a_layer(engine):
    frame, l2i = stream_request(engine, 1)
    h = engine.cfg.head
    before = engine.counters()
    for _ in range(3):
        engine.infer_stream(frame, l2i, stream="count")
    after = engine.counters()
    assert after["mp_graph_builds"] - before["mp_graph_builds"] == 3 * 6
    assert (after["mp_neighbour_rows"] - before["mp_neighbour_rows"]
            == 3 * 6 * h.num_neighbors * h.num_query)
    assert after["served"] - before["served"] == 3


def test_reference_loads_nothing_of_the_port_and_no_jax():
    code = (
        "import importlib, importlib.util, json, sys\n"
        f"d = {os.path.join(BENCH, 'reference')!r}\n"
        "spec = importlib.util.spec_from_file_location(\n"
        "    'ref', d + '/__init__.py', submodule_search_locations=[d])\n"
        "m = importlib.util.module_from_spec(spec); sys.modules['ref'] = m\n"
        "spec.loader.exec_module(m)\n"
        "importlib.import_module('ref.mp')\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=BENCH)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "torch" in loaded
    assert not [m for m in loaded
                if m.startswith("graph_detr4d_tpu") or m in ("jax", "jaxlib", "flax")]
