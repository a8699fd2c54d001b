"""The flagship's and MP's head eval forwards hold no host
synchronisation, so CUDA graphs can capture them (models/k1_graph.py,
models/head.py), and the device constants they read can still be saved
for autograd. Every decoder layer, whatever its cross-attention,
launches K1 only at its `steps` generator's yields; MP's also yields its
query graph and its neighbour span's opening and closing as eager
stretches, in their order.

CPU, K1's plain version; the capture itself and the replay are held to
the eager head on the card by tests/test_torch_cuda.py."""

import pytest
import torch

from graph_detr4d_tpu_torch import config as c
from graph_detr4d_tpu_torch import tracing
from graph_detr4d_tpu_torch.data.synthetic import synthetic_camera_rig
from graph_detr4d_tpu_torch.models.head import Detr3DHeadPE
from graph_detr4d_tpu_torch.models.k1_graph import Eager
from graph_detr4d_tpu_torch.models.transformer import DecoderLayer
from graph_detr4d_tpu_torch.ops import msda as msda_ops
from graph_detr4d_tpu_torch.weights import init_weights

SYNCS = ("item", "cpu", "tolist", "numpy", "__bool__", "__float__",
         "__int__")


def tiny_head(**kw):
    """The flagship head at a tiny width; cam_capacity 0.25 keeps 6 of 24
    queries a camera, so the compaction drops some. kw: HeadConfig
    fields to change (MP's attn_type and num_neighbors)."""
    cfg = c.HeadConfig(**{**dict(
        num_query=24, embed_dims=32, num_decoder_layers=2, num_heads=4,
        num_points=2, num_cams=12, num_frame_cams=6, ffn_dims=64,
        depth_num=8, pe_num_feats=16, with_detach=False, cam_capacity=0.25),
        **kw})
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


# the heads the card replays as CUDA graphs: the flagship's, and MP's
# (uncompacted: its overflow is 0)
GRAPHED_HEADS = {"flagship": {},
                 "mp": dict(attn_type="deform3d_mp", num_neighbors=4)}


@pytest.mark.parametrize("variant", sorted(GRAPHED_HEADS))
def test_head_eval_forward_makes_no_host_sync(monkeypatch, variant):
    """The second eval call of a signature (the one K1Graphs captures on
    the card; the first made the device constants and ran eagerly) with
    torch.tensor and the Tensor methods that read a value on the host
    patched to raise, MP's eager stretches (its query graph's topk,
    gather and repeats) included; then a training forward and backward
    through the same module, which saves those constants for autograd."""
    head = tiny_head(**GRAPHED_HEADS[variant]).eval()
    with torch.inference_mode():
        want = head(*request(0))
        with monkeypatch.context() as patched:
            patched.setattr(torch, "tensor", _refuse("torch.tensor"))
            for name in SYNCS:
                patched.setattr(torch.Tensor, name, _refuse(name))
            got = head(*request(0))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert (float(got["cam_overflow"]) > 0) == (variant == "flagship")
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


# the eager stretches (models/k1_graph.py::Eager) a layer yields beside
# its K1 calls, in order with them
YIELDS = {"deform3d_mp": ["query_graph", "k1", "open_neighbours", "k1",
                          "close_neighbours"]}


@pytest.mark.parametrize("attn_type,k1_calls", [
    ("deform3d", 1), ("deform3d_mp", 2), ("detr3d", 1), ("detr3d_v2", 1)])
def test_decoder_layer_launches_k1_only_at_its_yields(attn_type, k1_calls,
                                                      monkeypatch):
    """DecoderLayer.steps yields each K1 call of its cross-attention as
    the 5-tuple (value, spatial_shapes, loc, attn, index or None): one
    call, two for MP (centre, then neighbours). MP also yields eager
    stretches: the query graph before its centre call, its neighbour
    span's opening and closing around the neighbour call (`YIELDS`); each
    counts its work when it runs, and the span records under tracing.
    Driven by hand with msda_ops.msda_forward patched to raise, so that
    nothing but the loop driving it launches K1, it gives the layer's
    forward (dropout on, the same generator seed) bit for bit."""
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
    mp = layer.attentions[1]

    def counts():
        return (layer.mp_graph_builds, getattr(mp, "mp_neighbour_rows", 0))

    with torch.no_grad():
        want = layer(*args, torch.Generator().manual_seed(5))
        k1 = msda_ops.msda_forward
        monkeypatch.setattr(msda_ops, "msda_forward", _refuse("K1 launch"))
        steps = layer.steps(*args, torch.Generator().manual_seed(5))
        calls, order, seen, sent = 0, [], [], None
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
                    calls += 1
                    order.append("k1")
                    assert len(step) == 5
                    sent = k1(*step)
                seen.append(counts())
        finally:
            tracing.disable()
    spans = [r.name for r in tracing.drain()]
    assert calls == k1_calls
    assert order == YIELDS.get(attn_type, ["k1"])
    if attn_type == "deform3d_mp":
        # the graph counted by its stretch, the rows by the closing one
        # (the forward above counted one of each)
        rows = B * 4 * Q
        assert seen == 4 * [(2 * B, rows)] + [(2 * B, 2 * rows)]
        assert spans == ["model.head.graph", "model.head.neighbours"]
    else:
        assert spans == [] and counts() == (0, 0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
