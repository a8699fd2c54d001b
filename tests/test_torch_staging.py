"""serve.Engine's input copy (parallel/transfer.py: host_cast,
host_tensor, StagedCopy) on the CPU at tiny size:

  * the host half of the route, the cast into a preallocated buffer,
    is bit-equal to Tensor.to(torch.bfloat16) and to the round-to-
    nearest-even bit formula (the CUDA cast's rounding) on random values,
    ties, subnormals, the largest floats and +-inf, strided input too;
  * a bf16 Engine answers float32 images exactly as it answers the same
    images cast to bf16 beforehand;
  * the counters: a CPU Engine pins nothing (`h2d_staged` 0) and counts
    in `h2d_host_cast` the requests its route cast, none for a float32
    config, uint8 (device_normalize) images or bf16 images.

The card's half (pinned buffers, the copies, threads) is in
tests/test_torch_cuda.py, which builds its Engines and requests with
`tiny_engine`, `request` and `assert_same_answer` from here.
"""

import dataclasses

import numpy as np
import pytest
import torch

from graph_detr4d_tpu_torch.config import tiny_test_config
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D
from graph_detr4d_tpu_torch.parallel.transfer import (StagedCopy, host_cast,
                                                      host_tensor)
from graph_detr4d_tpu_torch.serve import Engine
from graph_detr4d_tpu_torch.weights import init_weights


def rne_bf16_bits(x):
    """bfloat16 bits of float32 x rounded to nearest even (no NaN)."""
    u = x.view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def edge_values():
    """Ties of both parities, values just off a tie, subnormals of
    float32 and of bfloat16, the largest floats (which round to inf),
    +-inf and signed zeros, as float32."""
    one = 0x3F800000  # 1.0
    bits = [one | 0x8000, one | 0x18000, one | 0x8001, one | 0x7FFF,  # ties
            0x00000001, 0x00008000, 0x00018000, 0x007FFFFF,  # subnormals
            0x00800000, 0x7F7FFFFF, 0x7F7F7FFF, 0x7F7F8000,  # largest
            0x7F800000, 0x00000000]
    v = np.array(bits, np.uint32).view(np.float32)
    return np.concatenate([v, -v])


CASES = {
    "random": lambda rng: rng.normal(0, 0.5, (2, 3, 5, 7, 3)).astype(np.float32),
    "wide": lambda rng: (rng.standard_cauchy((2, 3, 5, 7, 3)) * 1e30).astype(
        np.float32),
    "edges": lambda rng: np.resize(edge_values(), (2, 3, 5, 7, 3)),
    # strided: the same values with the camera axis last in memory
    "strided": lambda rng: np.moveaxis(np.ascontiguousarray(np.moveaxis(
        rng.normal(0, 0.5, (2, 3, 5, 7, 3)).astype(np.float32), 1, -1)),
        -1, 1),
    "flipped": lambda rng: np.flip(rng.normal(0, 0.5, (2, 3, 5, 7, 3)).astype(
        np.float32), 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_cast_is_the_bf16_cast_bit_for_bit(case):
    x = CASES[case](np.random.default_rng(0))
    buf = torch.full(x.shape, 7.0, dtype=torch.bfloat16)
    buf.copy_(host_tensor(x))  # StagedCopy's write into its pinned buffer
    got = buf.view(torch.int16).numpy().view(np.uint16)
    want = torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)
    np.testing.assert_array_equal(got, want.view(torch.int16).numpy().view(
        np.uint16))
    np.testing.assert_array_equal(got, rne_bf16_bits(np.ascontiguousarray(x)))


def test_host_cast_rule_reads_the_config_and_the_dtype():
    f32, bf16, u8, f16 = (torch.float32, torch.bfloat16, torch.uint8,
                          torch.float16)
    assert host_cast(f32, True, False) == bf16
    assert host_cast(f32, True, True) == f32  # normalised in fp32 first
    assert host_cast(f32, False, False) == f32
    assert host_cast(u8, True, True) == u8
    assert host_cast(f16, True, False) == f16
    assert host_cast(torch.float64, True, False) == torch.float64


def test_staged_copy_on_the_cpu_pins_nothing():
    staging = StagedCopy(torch.device("cpu"))
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    out = staging(x, torch.bfloat16)
    assert not staging.pinned and staging._free == {}
    assert out.dtype == torch.bfloat16 and not out.is_pinned()
    assert torch.equal(out, torch.from_numpy(x).to(torch.bfloat16))
    same = staging(x, torch.float32)  # its own dtype: the caller's memory
    assert same.dtype == torch.float32 and same.data_ptr() == x.ctypes.data


def tiny_engine(device="cpu", **changes):
    """serve.Engine on tiny_test_config (3 + 3 cameras, 64x128, the
    flagship's head) with `changes` and seeded weights, on `device`."""
    cfg = dataclasses.replace(tiny_test_config(), **changes)
    model = GraphDETR4D(cfg, device="cpu")
    init_weights(model, seed=0)
    return Engine(cfg, model.state_dict(), device=device)


@pytest.fixture(scope="module")
def bf16_engine():
    return tiny_engine(bf16=True)


def request(engine, seed, cams=None, dtype=np.float32):
    """Images (1, cams, H, W, 3), a frame's cameras by default, and a
    lidar2img of the whole rig, from `seed`."""
    h = engine.cfg.head
    H, W = engine.cfg.img_size
    rng = np.random.default_rng(seed)
    shape = (1, cams or h.num_frame_cams, H, W, 3)
    frame = (rng.integers(0, 256, shape).astype(dtype) if dtype == np.uint8
             else rng.normal(0, 0.5, shape).astype(dtype))
    l2i = np.tile(np.eye(4, dtype=np.float32), (1, h.num_cams, 1, 1))
    l2i[..., :3, 3] = rng.normal(0, 1, (1, h.num_cams, 3))
    return frame, l2i


def assert_same_answer(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_fp32_and_bf16_images_give_one_answer(bf16_engine):
    e = bf16_engine
    before = e.counters()
    for seed in (0, 1):
        frame, l2i = request(e, seed)
        rig, _ = request(e, seed + 10, cams=e.cfg.head.num_cams)
        frame_bf16 = torch.from_numpy(frame).to(torch.bfloat16)
        rig_bf16 = torch.from_numpy(rig).to(torch.bfloat16)
        assert_same_answer(e.infer_stream(frame, l2i, stream=f"f{seed}"),
                           e.infer_stream(frame_bf16, l2i, stream=f"b{seed}"))
        assert_same_answer(e.infer(rig, l2i), e.infer(rig_bf16, l2i))
    after = e.counters()
    delta = {k: after[k] - before[k] for k in
             ("served", "h2d_staged", "h2d_host_cast")}
    # the float32 half of the 8 requests was cast on the host
    assert delta == {"served": 8, "h2d_staged": 0, "h2d_host_cast": 4}


@pytest.mark.parametrize("changes,dtype", [
    ({"bf16": False}, np.float32),
    ({"bf16": True, "device_normalize": True}, np.uint8),
], ids=["fp32_config", "uint8_device_normalize"])
def test_uncast_routes_keep_their_dtype(changes, dtype):
    e = tiny_engine(**changes)
    frame, l2i = request(e, 0, dtype=dtype)
    images, lidar2img, kw, route = e._inputs(frame, l2i, [])
    assert images.dtype == torch.from_numpy(frame).dtype
    assert lidar2img.dtype == torch.float32 and kw == {}
    assert route == (False, False)
    e.infer_stream(frame, l2i)
    counts = e.counters()
    assert (counts["served"], counts["h2d_staged"],
            counts["h2d_host_cast"]) == (1, 0, 0)
