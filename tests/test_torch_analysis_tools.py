"""The port's analysis tools (graph_detr4d_tpu_torch/tools/{analyze_logs,
get_flops,int8_box_bound,parity_run}.py) against the JAX package's tools
on the CPU, tiny config:

  * analyze_logs: on a train_log.jsonl the port's Trainer wrote (2 steps),
    the port's cal_train_time line equals the JAX tool's; plot_curve
    writes an image;
  * get_flops --tiny: the convolutions and matrix products counted equal
    an analytic count made from every module's shapes; the kernels count
    by their formulas (K2 on the tiny config with DCN, each call's 2 M
    9Cin Cout); the JAX tool's XLA number is printed beside it;
  * int8_box_bound: box_drift gives the JAX tool's churn and deltas on
    the same two final-layer outputs, the JAX tool's main driven with a
    stand-in model that returns them; the CLI runs on the tiny config;
  * parity_run: a dry run on a nuScenes-layout fixture and a tiny
    reference-layout .pth exported by the JAX tools, on --device cpu.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tools import analyze_logs as jax_analyze_logs  # noqa: E402
from tools.convert_checkpoint import export_state_dict  # noqa: E402

from graph_detr4d_tpu import config as jax_config  # noqa: E402
from graph_detr4d_tpu.models import GraphDETR4D as JaxGraphDETR4D  # noqa: E402
from graph_detr4d_tpu_torch import config as port_config  # noqa: E402
from graph_detr4d_tpu_torch.data.fixture import write_nuscenes_fixture  # noqa: E402
from graph_detr4d_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D  # noqa: E402
from graph_detr4d_tpu_torch.models.transformer import MultiheadAttention  # noqa: E402
from graph_detr4d_tpu_torch.tools import analyze_logs, get_flops  # noqa: E402
from graph_detr4d_tpu_torch.tools import int8_box_bound, parity_run  # noqa: E402
from graph_detr4d_tpu_torch.tools import train as train_cli  # noqa: E402
from graph_detr4d_tpu_torch.weights import init_weights  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------ analyze_logs
@pytest.fixture(scope="module")
def train_log(tmp_path_factory):
    work = tmp_path_factory.mktemp("train")
    trainer = train_cli.main(["--tiny", "--synthetic", "--device", "cpu",
                              "--total-steps", "2", "--log-interval", "1",
                              "--work-dir", str(work)])
    del trainer
    return str(work / "train_log.jsonl")


def test_analyze_logs_matches_the_jax_tool(train_log, tmp_path, capsys):
    records = analyze_logs.load(train_log)
    assert len(records) == 2 and all("iter_time" in r for r in records)
    line = analyze_logs.cal_train_time(records)
    jax_analyze_logs.cal_train_time(jax_analyze_logs.load(train_log))
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed == [line, line]
    assert line.startswith("slowest iter_time: ")
    out = str(tmp_path / "curves.png")
    analyze_logs.main(["plot_curve", train_log, "--keys", "loss",
                       "loss_cls", "--out", out])
    assert os.path.getsize(out) > 0


# --------------------------------------------------------------- get_flops
def analytic_flops(model, cfg, images, lidar2img):
    """The convolutions and matrix products of one eval forward, from the
    shapes each module sees: every Linear / Conv2d (PointwiseConv
    included: 2 x in x out per output position), each MultiheadAttention
    (its three input projections and its two (Q, T) products), the
    attention's camera projection (a 4x4 product per projected point:
    32 FLOPs) and the head's back-projection of each level's pixels and
    depth bins (32 FLOPs each). The kernels are left out."""
    total = [0]
    h = cfg.head

    def linear(m, args, out):
        total[0] += 2 * m.in_features * out.numel()

    def conv(m, args, out):
        kh, kw = m.kernel_size
        total[0] += 2 * (m.in_channels // m.groups) * kh * kw * out.numel()

    def mha(m, args, out):
        query, key = args[0], args[1]
        B, Q, C = query.shape
        T = key.shape[1]
        total[0] += 2 * B * C * C * (Q + 2 * T) + 2 * 2 * B * Q * T * C

    hooks = []
    for mod in model.modules():
        if isinstance(mod, torch.nn.Linear):
            hooks.append(mod.register_forward_hook(linear))
        elif isinstance(mod, torch.nn.Conv2d):
            hooks.append(mod.register_forward_hook(conv))
        elif isinstance(mod, MultiheadAttention):
            hooks.append(mod.register_forward_hook(mha))
    try:
        with torch.no_grad():
            model(images, lidar2img)
    finally:
        for hk in hooks:
            hk.remove()
    B, N = images.shape[:2]
    H, W = cfg.img_size
    strides = [4 * 2 ** (cfg.neck.start_level + i)
               for i in range(cfg.neck.num_outs)]
    pixels = sum(math.ceil(H / s) * math.ceil(W / s) for s in strides)
    total[0] += 32 * B * N * pixels * h.depth_num
    total[0] += (32 * B * N * h.num_query * h.num_heads * h.num_levels
                 * h.num_points * h.num_decoder_layers)
    return total[0]


def tiny_model(cfg, seed=0):
    model = GraphDETR4D(cfg, device="cpu")
    init_weights(model, seed)
    b = synthetic_batch(cfg, 1)
    return (model.eval(), torch.from_numpy(b["images"]),
            torch.from_numpy(b["lidar2img"]))


def jax_xla_flops(cfg):
    """The JAX tool's number: XLA's cost analysis of the tiny forward."""
    model = JaxGraphDETR4D(cfg)
    b = synthetic_batch(cfg, 1)
    imgs, l2i = jnp.asarray(b["images"]), jnp.asarray(b["lidar2img"])
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(0)}, imgs,
                                    l2i)
    cost = jax.jit(lambda v, i, l: model.apply(v, i, l)).lower(
        variables, imgs, l2i).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    return float(cost.get("flops", float("nan")))


def test_get_flops_tiny_matches_an_analytic_count(capsys):
    cfg = port_config.tiny_test_config()
    out = get_flops.main(["--tiny", "--device", "cpu"])
    model, images, l2i = tiny_model(cfg)
    want = analytic_flops(model, cfg, images, l2i)
    assert out["matmul_conv"] == want
    # K1 a decoder layer, by its formula: at most 4 corners a sample
    h = cfg.head
    assert out["kernel_calls"] == {"msda_forward": h.num_decoder_layers,
                                   "deform_conv_forward": 0,
                                   "deform_conv_int8_forward": 0}
    samples = (h.num_cams * h.num_query * h.num_heads * h.num_levels
               * h.num_points * h.num_decoder_layers)
    hd = h.embed_dims // h.num_heads
    assert 0 < out["kernels"]["msda_forward"] <= 2 * hd * 4 * samples
    assert out["total"] == want + out["kernels"]["msda_forward"]
    xla = jax_xla_flops(jax_config.tiny_test_config())
    with capsys.disabled():
        print(f"\nget_flops --tiny: port {out['total']:,} (matmul and conv "
              f"{out['matmul_conv']:,}, K1 {out['kernels']['msda_forward']:,})"
              f"; JAX XLA {xla:,.0f}; ratio {out['total'] / xla:.4f}")


def test_get_flops_counts_dcn_by_its_formula():
    """K2 on the tiny config with DCN on stages 3-4: each call 2 M 9Cin
    Cout (from its input, offsets and weight), whichever route runs, and
    none of the plain version's own products in the matmul count."""
    cfg = port_config.tiny_test_config()
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, depth=50, use_dcn=True), neck=dataclasses.replace(
            cfg.neck, in_channels=(256, 512, 1024, 2048)))
    model, images, l2i = tiny_model(cfg)
    seen = []

    def record(m, args, out):
        x = args[0]  # NCHW
        seen.append(2 * out.shape[0] * out.shape[2] * out.shape[3] * 9
                    * x.shape[1] * m.weight.shape[0])

    from graph_detr4d_tpu_torch.models.resnet import DeformConv

    hooks = [m.register_forward_hook(record) for m in model.modules()
             if isinstance(m, DeformConv)]
    got = get_flops.count_forward(model, images, l2i)
    for hk in hooks:
        hk.remove()
    assert len(seen) == got["kernel_calls"]["deform_conv_forward"] > 0
    assert got["kernels"]["deform_conv_forward"] == sum(seen)
    want = analytic_flops(model, cfg, images, l2i)
    assert got["matmul_conv"] == want


# ---------------------------------------------------------- int8_box_bound
def drift_case(seed, cfg):
    """Two final-layer outputs (logits (1, Q, 10), codes (1, Q, 10)) a
    small perturbation apart, every centre inside post_center_range, no
    tied scores."""
    rng = np.random.RandomState(seed)
    Q = cfg.head.num_query
    cls = rng.randn(1, Q, 10).astype(np.float32)
    codes = np.concatenate([
        rng.uniform(-40, 40, (1, Q, 2)), rng.uniform(-0.5, 1.5, (1, Q, 2)),
        rng.uniform(-2, 1, (1, Q, 1)), rng.uniform(-0.5, 1.5, (1, Q, 1)),
        rng.uniform(-1, 1, (1, Q, 2)), rng.uniform(-3, 3, (1, Q, 2)),
    ], -1).astype(np.float32)
    cls2 = cls + rng.randn(*cls.shape).astype(np.float32) * 0.3
    codes2 = codes + rng.randn(*codes.shape).astype(np.float32) * 0.02
    return (cls, codes), (cls2, codes2)


class StandInModel:
    """Stands in for the JAX GraphDETR4D in tools/int8_box_bound.py: it
    returns the fixed outputs of its config's dcn_gather."""

    outputs = {}

    def __init__(self, cfg):
        self.cls, self.codes = self.outputs[cfg.backbone.dcn_gather]

    def init(self, rngs, images, lidar2img):
        return {}

    def apply(self, variables, images, lidar2img):
        return {"all_cls_scores": jnp.asarray(self.cls)[None],
                "all_bbox_preds": jnp.asarray(self.codes)[None]}


def parse_jax_drift(text):
    churn = int(re.search(r"selection churn: \[(\d+)\]", text).group(1))
    m = re.search(r"matched (\d+)/\d+: max \|d center\| ([\d.]+) m, \|d size\| "
                  r"([\d.]+), \|d yaw\| ([\d.]+) rad, \|d vel\| ([\d.]+), "
                  r"\|d score\| ([\d.]+)", text)
    vals = [float(x) for x in m.groups()]
    return churn, int(vals[0]), dict(zip(
        ("center", "size", "yaw", "velocity", "score"), vals[1:]))


@pytest.mark.parametrize("seed", [0, 1])
def test_box_drift_matches_the_jax_tool(seed, monkeypatch):
    import graph_detr4d_tpu.models as jax_models
    from tools import int8_box_bound as jax_tool

    cfg = jax_config.tiny_test_config()
    ref, got = drift_case(seed, cfg)
    monkeypatch.setattr(StandInModel, "outputs",
                        {"shift4": ref, "int8": got})
    monkeypatch.setattr(jax_models, "GraphDETR4D", StandInModel)
    monkeypatch.setattr(sys, "argv", ["int8_box_bound.py", "--tiny"])
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        jax_tool.main()
    churn, matched, deltas = parse_jax_drift(text.getvalue())
    drift = int8_box_bound.box_drift(
        tuple(torch.from_numpy(a) for a in ref),
        tuple(torch.from_numpy(a) for a in got), cfg.coder.max_num)
    assert drift["churn"] == churn > 0
    assert drift["matched"] == matched
    for k, v in deltas.items():  # the JAX tool prints 4-5 decimals
        places = 5 if k == "score" else 4
        assert round(drift["max_abs_delta"][k], places) == pytest.approx(
            v, abs=1.01 * 10 ** -places), k


def test_int8_box_bound_cli_tiny():
    drift = int8_box_bound.main(["--tiny", "--device", "cpu"])
    cfg = port_config.tiny_test_config()
    assert drift["selected"] == cfg.coder.max_num
    assert 0 <= drift["churn"] <= drift["selected"]
    assert drift["matched"] == drift["selected"] - drift["churn"]
    assert all(np.isfinite(v) for v in drift["max_abs_delta"].values())


# -------------------------------------------------------------- parity_run
@pytest.fixture(scope="module")
def parity_fixture(tmp_path_factory):
    """A nuScenes-layout fixture and a tiny reference-layout .pth exported
    from the JAX package's tiny model (tests/test_tools.py's recipe)."""
    root = tmp_path_factory.mktemp("parity")
    ann, _ = write_nuscenes_fixture(str(root / "nusc"), num_samples=2,
                                    src_hw=(90, 160), seed=5)
    cfg = jax_config.tiny_test_config()
    variables = jax.jit(JaxGraphDETR4D(cfg).init)(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, cfg.head.num_cams, *cfg.img_size, 3)),
        jnp.broadcast_to(jnp.eye(4), (1, cfg.head.num_cams, 4, 4)))
    sd = export_state_dict(jax.tree.map(np.asarray, dict(variables)),
                           cfg.head.num_decoder_layers, cfg.head.num_heads)
    pth = str(root / "epoch_1.pth")
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v))
                               for k, v in sd.items()}}, pth)
    return ann, pth, root


def parity_argv(ann, pth, work, *extra):
    return ["--pth", pth, "--ann-file", ann, "--tiny", "--device", "cpu",
            "--max-samples", "2", "--work-dir", str(work),
            "--extra-test-args=--no-temporal", *extra]


def test_parity_run_dry_run(parity_fixture, capsys):
    ann, pth, root = parity_fixture
    verdict, code = parity_run.main(parity_argv(
        ann, pth, root / "wd", "--baseline-map", "0.0", "--baseline-nds",
        "0.0"))
    assert code == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == verdict
    assert {"mAP", "NDS", "delta_mAP", "delta_NDS"} <= set(verdict)
    assert verdict["delta_mAP"] == verdict["mAP"]  # baseline 0
    with open(root / "wd" / "parity_results.json") as f:
        metrics = json.load(f)["metrics"]
    assert verdict["mAP"] == round(100.0 * metrics["mAP"], 2)


def test_parity_run_require_parity_fails_below_the_baseline(parity_fixture):
    ann, pth, root = parity_fixture
    verdict, code = parity_run.main(parity_argv(
        ann, pth, root / "wd2", "--baseline-map", "101.0", "--require-parity",
        "--tolerance", "0.5"))
    assert code == 1 and verdict["parity"] is False
    # no baseline row for the tiny config: refused under --require-parity
    args = parity_run.parse_args(parity_argv(ann, pth, root / "wd3",
                                             "--require-parity"))
    verdict, code = parity_run.verdict_of(args, "tiny",
                                          {"mAP": 0.5, "NDS": 0.5})
    assert code == 2 and verdict["error"] == "no baseline row"
    # the flagship's row: 34.2 mAP / 44.5 NDS within the tolerance passes
    verdict, code = parity_run.verdict_of(
        args, "detr4d_res50_deform_pe_testaug_2subset_12e",
        {"mAP": 0.338, "NDS": 0.441})
    assert code == 0 and verdict["parity"] is True
    assert verdict["delta_mAP"] == -0.4 and verdict["delta_NDS"] == -0.4
