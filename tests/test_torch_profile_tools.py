"""The port's profiling tools (graph_detr4d_tpu_torch/tools/
{profile_breakdown,profile_ops}.py) on the CPU:

  * profile_breakdown's ablation rows build the JAX tool's configs
    (tools/profile_breakdown.py::build, its model init and batch stubbed
    out), compared as dataclasses.asdict without the TPU layout fields;
    its timed functions compute the tiny model's features, forward and
    decode; the CPU timer;
  * profile_ops: `bucket` on CUDA kernel names, `kernel_records` /
    `aggregate` on synthetic profiler events, the excess table on
    synthetic records at two batch sizes, a CPU trace;
  * both CLIs raise without CUDA unless --device cpu, and run there
    (profile_ops with the bench config shrunk to the tiny one).
"""

import dataclasses
import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from graph_detr4d_tpu_torch.config import tiny_test_config  # noqa: E402
from graph_detr4d_tpu_torch.core.coder import decode_batch  # noqa: E402
from graph_detr4d_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D  # noqa: E402
from graph_detr4d_tpu_torch.tools import profile_breakdown, profile_ops  # noqa: E402
from graph_detr4d_tpu_torch.weights import init_weights  # noqa: E402

# fields the port accepts and does not act on (config.py): TPU layouts
TPU_LAYOUT = {"backbone": ("cam_chunk", "stem_s2d", "dcn_gather"),
              "head": ("batch_chunk", "msda_impl", "msda_late_proj")}


def _jax_breakdown():
    spec = importlib.util.spec_from_file_location(
        "jax_profile_breakdown", os.path.join(ROOT, "tools/profile_breakdown.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def without_layouts(cfg):
    d = dataclasses.asdict(cfg)
    for part, fields in TPU_LAYOUT.items():
        for f in fields:
            d[part].pop(f)
    return d


def test_ablations_build_the_jax_tools_configs(monkeypatch):
    jbd = _jax_breakdown()

    class NoModel:  # build's model: no init, no compile
        def __init__(self, cfg):
            self.cfg = cfg

        def init(self, *args, **kwargs):
            return None

    monkeypatch.setattr(jbd, "GraphDETR4D", NoModel)
    monkeypatch.setattr(jbd, "synthetic_batch", lambda cfg, batch_size: {
        "images": np.zeros(1, np.float32), "lidar2img": np.zeros(1, np.float32)})
    monkeypatch.setattr(jbd, "jax", types.SimpleNamespace(
        jit=lambda f: f, random=jbd.jax.random))
    for key in ("GRD4D_DCN_GATHER", "GRD4D_MSDA_IMPL", "GRD4D_MSDA_LATEPROJ",
                "GRD4D_STEM_S2D"):
        monkeypatch.delenv(key, raising=False)
    tags = [t for t, _ in profile_breakdown.ABLATIONS]
    assert [t.split(" (")[0] for t in tags] == [
        "bench", "cam_capacity off", "no dcn", "12-cam", "batch-2", "batch-4",
        "batch-4 cap off"]
    for tag, kw in profile_breakdown.ABLATIONS:
        kw = dict(kw)
        n = kw.pop("N", 6)
        kw.pop("batch_size", None)
        want = jbd.build(640, 1600, n, **kw)[0]
        got = profile_breakdown.bench_config(640, 1600, n, **kw)
        assert without_layouts(got) == without_layouts(want), tag
        assert got.img_size == (640, 1600) and got.bf16 and got.head.num_cams == n


def test_timed_functions_compute_the_forward():
    torch.manual_seed(0)
    cfg = tiny_test_config()
    model = GraphDETR4D(cfg, device="cpu")
    init_weights(model, 0)
    model.eval()
    b = synthetic_batch(cfg, 1)
    images, l2i = torch.as_tensor(b["images"]), torch.as_tensor(b["lidar2img"])
    feats, full, full_decode = profile_breakdown.stage_fns(cfg, model, images, l2i)
    with torch.no_grad():
        want = model(images, l2i)
        for a, w in zip(feats(), model.extract_feats(images)):
            assert torch.equal(a, w)
        got = full()
        for k in ("all_cls_scores", "all_bbox_preds", "cam_overflow"):
            assert torch.equal(got[k], want[k]), k
        out, det = full_decode()
        ref = decode_batch(want, max_num=cfg.coder.max_num,
                           post_center_range=cfg.coder.post_center_range)
    for a, w in zip(det, ref):
        assert torch.equal(a, w)
    assert torch.equal(out["all_cls_scores"], want["all_cls_scores"])
    calls = []
    ms = profile_breakdown.timed_ms(lambda: calls.append(1), torch.device("cpu"),
                                    iters=4, warmup=2)
    assert len(calls) == 6 and ms >= 0.0


@pytest.mark.parametrize("name,want", [
    ("msda_forward_kernel<__nv_bfloat16>", "msda"),
    ("void msda_value_grad_kernel<float>(Entry const*)", "msda"),
    ("deform_conv_fwd_kernel<bf16_gather>", "deform_conv"),
    ("void (anonymous namespace)::deform_conv_fwd_kernel<__nv_bfloat16>", "deform_conv"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "conv (cuDNN)"),
    ("cudnn::bn_fw_inf_1C11_kernel_NCHW", "conv (cuDNN)"),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NNT", "gemm (cuBLAS)"),
    ("ampere_sgemm_128x64_nn", "gemm (cuBLAS)"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("void at::native::reduce_kernel<512, 1, ...>", "reduce"),
    ("void at::native::(anonymous)::cunn_SoftMaxForward<4, float>", "reduce"),
    ("Memcpy HtoD (Pageable -> Device)", "copy / memcpy"),
    ("void at::native::CatArrayBatchedCopy<...>", "copy / memcpy"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "nccl"),
    ("void at::native::index_elementwise_kernel", "elementwise"),
    ("void at::native::_scatter_gather_elementwise_kernel", "elementwise"),
    ("hungarian_lsa", "other"),
    ("void DSE::vector_fft<0, 1, 256, 16, 16, 1, float, float, float2>", "conv (cuDNN)"),
])
def test_bucket(name, want):
    assert profile_ops.bucket(name) == want


def test_bucket_by_the_launching_operator():
    """cuDNN's FFT engine runs complex GEMMs under the conv operator."""
    name = "sm80_xmma_gemm_cf32cf32_f32f32_cf32_tn_n_tilesize32x32x8"
    assert profile_ops.bucket(name) == "gemm (cuBLAS)"
    assert profile_ops.bucket(name, "aten::cudnn_convolution") == "conv (cuDNN)"
    assert profile_ops.bucket("ampere_sgemm_128x64_nn", "aten::mm") == "gemm (cuBLAS)"
    # the port's kernels keep their bucket under whatever operator claims them
    assert profile_ops.bucket("deform_conv_fwd_kernel", "aten::convolution") == "deform_conv"


def _kernel(name, us, start=0.0, corr=0):
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA, id=corr,
        time_range=types.SimpleNamespace(start=start, end=start + us,
                                         elapsed_us=lambda: us))


def _op(name, shapes):
    return types.SimpleNamespace(name=name, device_type=DeviceType.CPU,
                                 input_shapes=shapes, id=0, cpu_parent=None)


def _launch(corr, op):
    """The runtime call that launched a kernel: its correlation id, and
    the operator it ran under."""
    return types.SimpleNamespace(name="cudaLaunchKernel", device_type=DeviceType.CPU,
                                 input_shapes=[], id=corr, cpu_parent=op)


def synthetic_events(b):
    """A trace of 3 forwards at batch b: a conv launched by an operator
    (linear in b), a GEMM whose time grows as b^2, and a ctypes kernel
    launched outside any operator (linear), as PyTorch 2.11 records them:
    operator ids and correlation ids from separate counters."""
    events = []
    for f in range(3):
        conv = _op("aten::cudnn_convolution", [[6 * b, 256, 40, 100], [256, 256, 3, 3]])
        bmm = _op("aten::bmm", [[6 * b, 900, 256], [6 * b, 256, 256]])
        c = 100 * f
        events += [
            conv, _launch(c + 1, conv), _kernel("conv_fprop", 100.0 * b, corr=c + 1),
            bmm, _launch(c + 2, bmm), _kernel("nvjet_gemm", 10.0 * b * b, corr=c + 2),
            _launch(c + 3, None), _kernel("msda_forward_kernel", 50.0 * b, corr=c + 3),
        ]
    return events


def test_records_and_aggregate():
    recs = profile_ops.kernel_records(synthetic_events(2))
    assert len(recs) == 9  # one a device event
    assert ("conv_fprop", "aten::cudnn_convolution",
            ((12, 256, 40, 100), (256, 256, 3, 3)), 200.0) in recs
    assert ("msda_forward_kernel", "", (), 100.0) in recs
    assert profile_ops.aggregate(recs) == {
        "conv_fprop": 600.0, "nvjet_gemm": 120.0, "msda_forward_kernel": 300.0}
    rep = profile_ops.report(recs, span_ms=2.0, busy_ms=0.9, top=2)
    assert rep["device_ms"] == pytest.approx(1.02) and rep["span_ms"] == 2.0
    assert rep["busy_ms"] == 0.9
    assert rep["buckets"]["conv (cuDNN)"] == pytest.approx(0.2)
    assert [n for n, _ in rep["top"]] == ["conv_fprop", "msda_forward_kernel"]


def test_busy_time_counts_overlaps_once():
    events = [_kernel("a", 10.0, 0.0), _kernel("b", 10.0, 5.0),
              _kernel("c", 2.0, 30.0), _kernel("d", 1.0, 30.5),
              _op("aten::mm", [])]
    assert profile_ops.busy_us(events) == pytest.approx(17.0)
    assert sum(r[3] for r in profile_ops.kernel_records(events)) == 23.0


def test_excess_table():
    assert profile_ops.signature("k", [[12, 3], [], [7]], 2) == "k [B*6,3] [*]"
    assert profile_ops.signature("k", [[66, 3]], 2) == "k [66,3]"  # 33 > 32
    # a broadcast operand's leading 1 is no batch: B=1 and B=2 pair
    assert (profile_ops.signature("add", [[6, 256, 40], [1, 256, 1]], 1)
            == profile_ops.signature("add", [[12, 256, 40], [1, 256, 1]], 2)
            == "add [B*6,256,40] [*,256,1]")
    r1 = profile_ops.kernel_records(synthetic_events(1))
    r4 = profile_ops.kernel_records(synthetic_events(4))
    rows = profile_ops.excess_rows(r1, r4, 1, 4)
    ex, t4, t1, sig = rows[0]
    assert sig == "nvjet_gemm [B*6,900,256] [*,256,256]"
    assert t4 == pytest.approx(0.16) and t1 == pytest.approx(0.01)
    assert ex == pytest.approx(0.12)
    by_sig = {r[3]: r[0] for r in rows}
    assert by_sig["conv_fprop [B*6,256,40,100] [*,256,3,3]"] == pytest.approx(0.0)
    assert by_sig["msda_forward_kernel"] == pytest.approx(0.0)


def test_kernel_records_link_a_real_trace():
    """The operators of a real (CPU) trace carry their input shapes to the
    kernels whose launch calls ran under them."""
    x = torch.randn(64, 64)
    prof, _ = profile_ops.trace_forward(lambda: x @ x, torch.device("cpu"))
    ops = [e for e in prof.events() if e.name == "aten::mm"]
    extra = []
    for i, op in enumerate(ops):
        extra += [_launch(10_000 + i, op), _kernel("gemm", 1.0, corr=10_000 + i)]
    recs = profile_ops.kernel_records(prof.events() + extra)
    assert recs == [("gemm", "aten::mm", ((64, 64), (64, 64)), 1.0)] * 3


def test_cpu_trace_has_no_device_time():
    x = torch.randn(64, 64)
    prof, span = profile_ops.trace_forward(lambda: x @ x, torch.device("cpu"))
    assert span > 0 and profile_ops.kernel_records(prof.events()) == []
    ops = [e for e in prof.events() if e.name == "aten::mm"]
    assert len(ops) == 3 and all(e.input_shapes == [[64, 64], [64, 64]] for e in ops)


def test_clis_need_cuda_or_the_cpu(monkeypatch, capsys):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_breakdown.main(["bench"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_ops.main(["--b", "1"])
    assert profile_breakdown.main(["no-such-row", "--device", "cpu"]) == {}
    monkeypatch.setattr(profile_breakdown, "bench_config",
                        lambda H, W, N, use_dcn=True, cam_capacity=0.5:
                        tiny_test_config())
    out = profile_ops.main(["--b", "1", "2", "--top", "3", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "== B=1" in text and "== B=2" in text and "excess" in text
    assert out[1]["device_ms"] == 0.0 and out[2]["span_ms"] > 0
