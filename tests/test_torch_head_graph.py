"""The flagship head's eval forward holds no host synchronisation, so a
CUDA graph can capture it (models/k1_graph.py, models/head.py), and the
device constants it reads can still be saved for autograd.

CPU, K1's plain version; the capture itself and the replay are held to
the eager head on the card by tests/test_torch_cuda.py."""

import pytest
import torch

from graph_detr4d_tpu_torch import config as c
from graph_detr4d_tpu_torch.data.synthetic import synthetic_camera_rig
from graph_detr4d_tpu_torch.models.head import Detr3DHeadPE
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
    from graph_detr4d_tpu_torch.ops import msda as msda_ops

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
