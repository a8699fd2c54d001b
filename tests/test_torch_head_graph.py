"""The flagship head's eval forward holds no host synchronisation, so a
CUDA graph can capture it (models/k1_graph.py, models/head.py), and the
device constants it reads can still be saved for autograd. Every decoder
layer, whatever its cross-attention, launches K1 only at its `steps`
generator's yields.

CPU, K1's plain version; the capture itself and the replay are held to
the eager head on the card by tests/test_torch_cuda.py."""

import pytest
import torch

from graph_detr4d_tpu_torch import config as c
from graph_detr4d_tpu_torch.data.synthetic import synthetic_camera_rig
from graph_detr4d_tpu_torch.models.head import Detr3DHeadPE
from graph_detr4d_tpu_torch.models.transformer import DecoderLayer
from graph_detr4d_tpu_torch.ops import msda as msda_ops
from graph_detr4d_tpu_torch.weights import init_weights

SYNCS = ("item", "cpu", "tolist", "numpy", "__bool__", "__float__",
         "__int__")


def tiny_head():
    """The flagship head at a tiny width; cam_capacity 0.25 keeps 6 of 24
    queries a camera, so the compaction drops some."""
    cfg = c.HeadConfig(num_query=24, embed_dims=32, num_decoder_layers=2,
                       num_heads=4, num_points=2, num_cams=12,
                       num_frame_cams=6, ffn_dims=64, depth_num=8,
                       pe_num_feats=16, with_detach=False, cam_capacity=0.25)
    head = Detr3DHeadPE(cfg, (64, 160))
    init_weights(head, seed=0)
    return head


def request(seed):
    g = torch.Generator().manual_seed(seed)
    feats = [torch.randn(1, 12, h, w, 32, generator=g)
             for h, w in ((8, 20), (4, 10), (2, 5), (1, 3))]
    l2i = torch.from_numpy(synthetic_camera_rig(12, (64, 160), seed=seed))
    return feats, l2i[None]


def _refuse(name):
    def refuse(*args, **kwargs):
        raise AssertionError(f"{name}: a host sync in the head's forward")
    return refuse


def test_head_eval_forward_makes_no_host_sync(monkeypatch):
    """The second eval call of a signature (the one K1Graphs captures on
    the card; the first made the device constants and ran eagerly) with
    torch.tensor and the Tensor methods that read a value on the host
    patched to raise; then a training forward and backward through the
    same module, which saves those constants for autograd."""
    head = tiny_head().eval()
    with torch.inference_mode():
        want = head(*request(0))
        with monkeypatch.context() as patched:
            patched.setattr(torch, "tensor", _refuse("torch.tensor"))
            for name in SYNCS:
                patched.setattr(torch.Tensor, name, _refuse(name))
            got = head(*request(0))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert float(got["cam_overflow"]) > 0
    head.train()
    feats, l2i = request(1)
    g = torch.Generator().manual_seed(0)
    out = head(feats, l2i, generator=g)
    (out["all_cls_scores"].sum() + out["all_bbox_preds"].sum()).backward()
    grad = head.query_embedding.weight.grad
    assert grad is not None and bool(torch.isfinite(grad).all())


@pytest.mark.parametrize("train", [False, True])
def test_head_steps_yield_each_layers_k1_call(train):
    """head.steps yields K1's arguments once a decoder layer, and driving
    it by hand gives forward's outputs bit for bit."""
    head = tiny_head().train(train)
    feats, l2i = request(2)

    def gen():
        return None if not train else torch.Generator().manual_seed(5)

    with torch.no_grad():
        want = head(feats, l2i, generator=gen())
        steps = head.steps(feats, l2i, generator=gen())
        calls, sent = 0, None
        while True:
            try:
                args = steps.send(sent)
            except StopIteration as done:
                got = done.value
                break
            calls += 1
            sent = msda_ops.msda_forward(*args)
    assert calls == head.cfg.num_decoder_layers
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("attn_type,k1_calls", [
    ("deform3d", 1), ("deform3d_mp", 2), ("detr3d", 1), ("detr3d_v2", 1)])
def test_decoder_layer_launches_k1_only_at_its_yields(attn_type, k1_calls,
                                                      monkeypatch):
    """DecoderLayer.steps yields each K1 call of its cross-attention as
    the 5-tuple (value, spatial_shapes, loc, attn, index or None): one
    call, two for MP (centre, then neighbours). Driven by hand with
    msda_ops.msda_forward patched to raise, so that nothing but the loop
    driving it launches K1, it gives the layer's forward (dropout on,
    the same generator seed) bit for bit."""
    B, Q, C, N, img = 2, 16, 32, 6, (64, 160)
    shapes = [(8, 20), (4, 10)]
    layer = DecoderLayer(embed_dims=C, num_heads=4, num_levels=2,
                         num_points=4, num_cams=N, ffn_dims=64,
                         pc_range=c.DEFAULT_PC_RANGE, attn_type=attn_type,
                         num_neighbors=4)
    init_weights(layer, seed=0)
    g = torch.Generator().manual_seed(3)
    l2i = torch.from_numpy(synthetic_camera_rig(N, img, seed=1))
    args = (torch.randn(B, Q, C, generator=g),
            torch.randn(B, Q, C, generator=g),
            torch.randn(B, N, sum(h * w for h, w in shapes), C, generator=g),
            shapes, 0.05 + 0.9 * torch.rand(B, Q, 3, generator=g),
            l2i[None].expand(B, N, 4, 4), img)
    with torch.no_grad():
        want = layer(*args, torch.Generator().manual_seed(5))
        k1 = msda_ops.msda_forward
        monkeypatch.setattr(msda_ops, "msda_forward", _refuse("K1 launch"))
        steps = layer.steps(*args, torch.Generator().manual_seed(5))
        calls, sent = 0, None
        while True:
            try:
                k1_args = steps.send(sent)
            except StopIteration as done:
                got = done.value
                break
            calls += 1
            assert len(k1_args) == 5
            sent = k1(*k1_args)
    assert calls == k1_calls
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
