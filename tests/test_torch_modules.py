"""The port's modules (plain kernel versions, CPU, fp32) against the JAX
modules with the same weights.

Each JAX module is initialised by flax, its zero-initialised parameters
(DCN offset/mask convs, sampling offsets, attention and camera-gate
projections) and its FrozenBN statistics are replaced by seeded noise so
they matter, and the weights reach the port through
graph_detr4d_tpu_torch.weights, loaded with strict=True. Inputs are made
with numpy from a seed. Tolerances: atol 1e-4 per module, the JAX
goldens' own (tests/test_golden_torch.py:92-97, 144-149).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_detr4d_tpu.config import HeadConfig as JaxHeadConfig
from graph_detr4d_tpu.data.synthetic import synthetic_camera_rig
from graph_detr4d_tpu.models import attention as jax_attention
from graph_detr4d_tpu.models import fpn as jax_fpn
from graph_detr4d_tpu.models import head as jax_head
from graph_detr4d_tpu.models import positional as jax_pos
from graph_detr4d_tpu.models import resnet as jax_resnet
from graph_detr4d_tpu.models import transformer as jax_transformer
from graph_detr4d_tpu_torch import weights
from graph_detr4d_tpu_torch.config import HeadConfig
from graph_detr4d_tpu_torch.models import attention, fpn, head, positional
from graph_detr4d_tpu_torch.models import resnet, transformer
from graph_detr4d_tpu_torch.ops import msda as msda_ops

ATOL = 1e-4
PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
ZERO_INIT = ("conv_offset", "cam_attention_weights", "attention_weights")


def perturb_variables(variables, seed=0):
    """numpy copy of flax variables with the zero-initialised projections
    and the FrozenBN statistics replaced by seeded noise."""
    rng = np.random.RandomState(seed)

    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        a = np.asarray(node, np.float32)
        if path[0] == "batch_stats":
            lo, hi = {"gamma": (0.5, 1.5), "var": (0.5, 1.5)}.get(
                path[-1], (-0.2, 0.2))
            return rng.uniform(lo, hi, a.shape).astype(np.float32)
        zero_init = any(k in path for k in ZERO_INIT) or (
            "sampling_offsets" in path and path[-1] == "kernel")
        if not zero_init:
            return a
        if path[-1] == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            return (rng.randn(*a.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "sampling_offsets" in path:  # keep the cone bias
            return a
        return (rng.randn(*a.shape) * 0.1).astype(np.float32)

    return walk(dict(variables), ())


def jax_vars(v):
    return jax.tree_util.tree_map(jnp.asarray, v)


def load(module, sd):
    module.load_state_dict(weights.to_torch(sd), strict=True)
    return module.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


@pytest.mark.parametrize("depth", [18, 50])
def test_resnet_matches_jax(depth):
    """ResNet-50 with DCNv2 on stages 3-4 (the flagship) and ResNet-18
    (BasicBlock, which has no DCN in mmdet)."""
    x = np.random.RandomState(0).randn(2, 64, 96, 3).astype(np.float32)
    model = jax_resnet.ResNet(depth=depth, use_dcn=depth == 50)
    v = perturb_variables(
        jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jax.jit(model.apply)(jax_vars(v), jnp.asarray(x))

    port = load(resnet.ResNet(depth=depth, use_dcn=depth == 50),
                weights.backbone_state_dict(v["params"], v["batch_stats"]))
    if depth == 50:
        assert isinstance(port.layer3[0].conv2, resnet.DeformConv)
    with torch.no_grad():
        got = port(nchw(x))
    for stage, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(
            g.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=1e-4,
            atol=ATOL, err_msg=f"stage {stage}")


def test_fpn_matches_jax():
    rng = np.random.RandomState(1)
    chans, sizes = (16, 32, 48, 64), ((32, 40), (16, 20), (8, 10), (4, 5))
    xs = [rng.randn(2, h, w, c).astype(np.float32)
          for c, (h, w) in zip(chans, sizes)]
    model = jax_fpn.FPN(out_channels=24)
    v = perturb_variables(model.init(jax.random.PRNGKey(1),
                                     [jnp.asarray(x) for x in xs]))
    want = model.apply(jax_vars(v), [jnp.asarray(x) for x in xs])

    port = load(fpn.FPN(chans, out_channels=24),
                weights.neck_state_dict(v["params"]))
    with torch.no_grad():
        got = port([nchw(x) for x in xs])
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=0, atol=ATOL)


def _head_cfg():
    kw = dict(num_query=16, embed_dims=32, num_decoder_layers=2,
              num_heads=4, num_levels=2, num_points=2, num_cams=6,
              ffn_dims=64, depth_num=8, pe_num_feats=16, dropout=0.0,
              with_detach=False, num_frame_cams=6, cam_capacity=0.5)
    return JaxHeadConfig(**kw), HeadConfig(**kw)


def test_positional_encodings_match_jax():
    mask = np.zeros((2, 6, 5, 7), np.float32)
    mask[:, :, -1] = 1.0
    want = jax_pos.sine_positional_encoding_3d(jnp.asarray(mask), num_feats=16)
    got = positional.sine_positional_encoding_3d(torch.from_numpy(mask), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(
        positional.lid_depth_bins(64, 1.0, 51.2).numpy(),
        np.asarray(jax_pos.lid_depth_bins(64, 1.0, 51.2)), rtol=1e-6)

    jcfg, tcfg = _head_cfg()
    img = (64, 160)
    feat = np.zeros((1, 6, 8, 20, 32), np.float32)
    l2i = synthetic_camera_rig(6, img)[None]
    want = jax_head.Detr3DHeadPE(jcfg, img_shape=img).apply(
        {}, jnp.asarray(feat), jnp.asarray(l2i),
        method=jax_head.Detr3DHeadPE._position_embedding)
    got = head.Detr3DHeadPE(tcfg, img).position_embedding(
        torch.from_numpy(feat), torch.from_numpy(l2i))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=ATOL)


def _attn_inputs(jcfg, overflow, seed=2):
    """Queries, flattened values and reference points for a 6-camera rig.
    overflow=True puts every reference point in front of camera 0, so
    more than cam_capacity * Q queries are in view there."""
    rng = np.random.RandomState(seed)
    B, Q, C, N = 2, jcfg.num_query, jcfg.embed_dims, jcfg.num_cams
    img = (64, 160)
    shapes = [(8, 20), (4, 10)]
    query = rng.randn(B, Q, C).astype(np.float32)
    query_pos = rng.randn(B, Q, C).astype(np.float32)
    levels = [rng.randn(B, N, h, w, C).astype(np.float32) for h, w in shapes]
    if overflow:  # ~12 m ahead of the rig, along camera 0's axis
        ref = np.stack([rng.uniform(0.6, 0.64, (B, Q)),
                        rng.uniform(0.48, 0.52, (B, Q)),
                        rng.uniform(0.5, 0.7, (B, Q))], -1)
    else:
        ref = rng.uniform(0.05, 0.95, (B, Q, 3))
    l2i = np.stack([synthetic_camera_rig(N, img, seed=b) for b in range(B)])
    return dict(query=query, query_pos=query_pos, levels=levels,
                shapes=shapes, ref=ref.astype(np.float32), l2i=l2i, img=img)


def _flat_levels(levels):
    return torch.from_numpy(np.concatenate(
        [v.reshape(*v.shape[:2], -1, v.shape[-1]) for v in levels], axis=2))


@pytest.mark.parametrize("route", ["forward", "split"])
@pytest.mark.parametrize("overflow", [False, True])
def test_deform3d_cross_attn_matches_jax(overflow, route):
    """cam_capacity=0.5 compaction. With overflow every query is in view
    of camera 0 (all tied), so the result also holds the port's selection
    to jax.lax.top_k's tie order: lower query index first. torch.topk
    promises no order among ties; the port sorts stably. The split route
    drives the module's `steps` generator itself, K1 (msda_forward's
    plain version here) launched at its one yield, as the head's CUDA
    graphs do (models/k1_graph.py), and must equal `forward` bit for
    bit."""
    jcfg, _ = _head_cfg()
    d = _attn_inputs(jcfg, overflow)
    mod = jax_attention.Deform3DCrossAttn(
        embed_dims=jcfg.embed_dims, num_heads=jcfg.num_heads,
        num_levels=jcfg.num_levels, num_points=jcfg.num_points,
        num_cams=jcfg.num_cams, pc_range=PC_RANGE, dropout=0.0,
        cam_capacity=jcfg.cam_capacity)
    args = (jnp.asarray(d["query"]), [jnp.asarray(v) for v in d["levels"]],
            jnp.asarray(d["query_pos"]), jnp.asarray(d["ref"]),
            jnp.asarray(d["l2i"]), d["img"])
    v = perturb_variables(mod.init(jax.random.PRNGKey(2), *args), seed=3)
    want, state = mod.apply(jax_vars(v), *args, mutable=["intermediates"])
    want_overflow = float(sum(np.asarray(x) for x in
                              state["intermediates"]["cam_overflow"]))

    port = load(attention.Deform3DCrossAttn(
        embed_dims=jcfg.embed_dims, num_heads=jcfg.num_heads,
        num_levels=jcfg.num_levels, num_points=jcfg.num_points,
        num_cams=jcfg.num_cams, pc_range=PC_RANGE,
        cam_capacity=jcfg.cam_capacity),
        weights.cross_attn_state_dict(v["params"]))
    args = (torch.from_numpy(d["query"]), _flat_levels(d["levels"]),
            d["shapes"], torch.from_numpy(d["query_pos"]),
            torch.from_numpy(d["ref"]), torch.from_numpy(d["l2i"]), d["img"])
    with torch.no_grad():
        got, got_overflow = port(*args)
        if route == "split":
            steps = port.steps(*args)
            k1_args = next(steps)
            with pytest.raises(StopIteration) as done:
                steps.send(msda_ops.msda_forward(*k1_args))
            split, split_overflow = done.value.value
            assert torch.equal(split, got)
            assert torch.equal(split_overflow, got_overflow)
            got, got_overflow = split, split_overflow
    assert float(got_overflow) == want_overflow
    assert (want_overflow > 0) == overflow
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_decoder_layer_matches_jax():
    jcfg, _ = _head_cfg()
    d = _attn_inputs(jcfg, overflow=False, seed=4)
    mod = jax_transformer.DecoderLayer(
        embed_dims=jcfg.embed_dims, num_heads=jcfg.num_heads,
        num_levels=jcfg.num_levels, num_points=jcfg.num_points,
        num_cams=jcfg.num_cams, ffn_dims=jcfg.ffn_dims, pc_range=PC_RANGE,
        dropout=0.0, cam_capacity=jcfg.cam_capacity)
    args = (jnp.asarray(d["query"]), jnp.asarray(d["query_pos"]),
            [jnp.asarray(v) for v in d["levels"]], jnp.asarray(d["ref"]),
            jnp.asarray(d["l2i"]), d["img"])
    v = perturb_variables(mod.init(jax.random.PRNGKey(4), *args), seed=5)
    want = mod.apply(jax_vars(v), *args)

    port = load(transformer.DecoderLayer(
        embed_dims=jcfg.embed_dims, num_heads=jcfg.num_heads,
        num_levels=jcfg.num_levels, num_points=jcfg.num_points,
        num_cams=jcfg.num_cams, ffn_dims=jcfg.ffn_dims, pc_range=PC_RANGE,
        cam_capacity=jcfg.cam_capacity),
        weights.decoder_layer_state_dict(v["params"]))
    with torch.no_grad():
        got, _ = port(
            torch.from_numpy(d["query"]), torch.from_numpy(d["query_pos"]),
            _flat_levels(d["levels"]), d["shapes"], torch.from_numpy(d["ref"]),
            torch.from_numpy(d["l2i"]), d["img"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)



def test_geometry_and_synthetic_inputs_match_jax():
    from graph_detr4d_tpu.data.synthetic import synthetic_batch as jax_batch
    from graph_detr4d_tpu.geometry.boxes import denormalize_bbox as jax_denorm
    from graph_detr4d_tpu.geometry.projection import inv4x4 as jax_inv4x4
    from graph_detr4d_tpu.utils.math import inverse_sigmoid as jax_invsig
    from graph_detr4d_tpu_torch.config import tiny_test_config
    from graph_detr4d_tpu_torch.data.synthetic import synthetic_batch
    from graph_detr4d_tpu_torch.geometry.boxes import denormalize_bbox
    from graph_detr4d_tpu_torch.geometry.projection import inv4x4
    from graph_detr4d_tpu_torch.utils.math import inverse_sigmoid

    cfg = dataclasses.replace(tiny_test_config(), img_size=(64, 160))
    got = synthetic_batch(cfg, batch_size=2, seed=3)
    want = jax_batch(cfg, batch_size=2, seed=3)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    l2i = got["lidar2img"]
    np.testing.assert_allclose(inv4x4(torch.from_numpy(l2i)).numpy(),
                               np.asarray(jax_inv4x4(jnp.asarray(l2i))),
                               rtol=1e-5, atol=1e-6)
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.uniform(-0.1, 1.1, 50), [0.0, 1.0]]).astype(np.float32)
    np.testing.assert_allclose(inverse_sigmoid(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_invsig(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    codes = rng.randn(7, 10).astype(np.float32)
    np.testing.assert_allclose(denormalize_bbox(torch.from_numpy(codes)).numpy(),
                               np.asarray(jax_denorm(jnp.asarray(codes))),
                               rtol=1e-6, atol=1e-6)


def test_decode_keeps_jax_top_k_order_among_tied_scores():
    """nms_free_decode with tied scores: jax.lax.top_k takes the lower
    flat index first, and so must the port."""
    from graph_detr4d_tpu.core.coder import decode_batch as jax_decode
    from graph_detr4d_tpu_torch.core.coder import decode_batch

    rng = np.random.RandomState(1)
    cls = np.round(rng.randn(2, 1, 30, 10), 0).astype(np.float32)  # ties
    box = (rng.randn(2, 1, 30, 10) * 30).astype(np.float32)
    kw = dict(max_num=40, post_center_range=(-40, -40, -10, 40, 40, 10))
    got = decode_batch({"all_cls_scores": torch.from_numpy(cls),
                        "all_bbox_preds": torch.from_numpy(box)}, **kw)
    want = jax_decode({"all_cls_scores": jnp.asarray(cls),
                       "all_bbox_preds": jnp.asarray(box)}, **kw)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert not got.valid.all() and got.valid.any()
    np.testing.assert_allclose(got.bboxes.numpy(), np.asarray(want.bboxes),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6)
