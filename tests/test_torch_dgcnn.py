"""The LiDAR branch (models/dgcnn.py) against the JAX package's
graph_detr4d_tpu/models/dgcnn.py (plain kernel versions, CPU, fp32).

Each module and the whole ObjDGCNN, with flax weights (zero-initialised
projections and frozen-BN statistics replaced by seeded noise) carried
over by graph_detr4d_tpu_torch.weights and loaded with strict=True. The
grid is 30 x 22, so the SECOND stages halve to odd sizes (15 x 11, 8 x 6):
there flax's 'SAME' stride-2 padding and jax.image.resize's nearest rule
differ from the obvious PyTorch calls. Tolerances: 1e-4 per module, 2e-4
on the head's raw outputs (the JAX goldens' own,
tests/test_golden_full_model.py:18-19); decoded labels equal.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from graph_detr4d_tpu.config import HeadConfig as JaxHeadConfig  # noqa: E402
from graph_detr4d_tpu.core.coder import decode_batch as jax_decode  # noqa: E402
from graph_detr4d_tpu.models import dgcnn as jax_dgcnn  # noqa: E402
from graph_detr4d_tpu.models import positional as jax_pos  # noqa: E402
from graph_detr4d_tpu_torch import weights  # noqa: E402
from graph_detr4d_tpu_torch.config import HeadConfig  # noqa: E402
from graph_detr4d_tpu_torch.core.coder import decode_batch  # noqa: E402
from graph_detr4d_tpu_torch.models import dgcnn, positional  # noqa: E402
from tests.test_torch_modules import jax_vars, load, perturb_variables  # noqa: E402

ATOL, HEAD_ATOL = 1e-4, 2e-4
PC = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
GRID = (30, 22)


def _head_cfgs(**kw):
    base = dict(num_query=24, embed_dims=32, num_decoder_layers=2,
                num_heads=4, num_levels=4, num_points=2, ffn_dims=64,
                dropout=0.0, pc_range=PC)
    base.update(kw)
    return JaxHeadConfig(**base), HeadConfig(**base)


def _knn_margin(x, k):
    """Smallest gap, over rows, between the k-th and (k+1)-th largest
    squared distance, relative to the row's scale: the k-NN set is then
    robust to the two sides' rounding."""
    x = np.asarray(x, np.float64)
    d2 = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
    s = -np.sort(-d2, axis=-1)
    return ((s[..., k - 1] - s[..., k]) / s[..., 0]).min()


def test_sine_positional_encoding_2d_matches_jax():
    want = jax_pos.sine_positional_encoding_2d(5, 7, 16)
    got = positional.sine_positional_encoding_2d(5, 7, 16)
    assert got.shape == (5, 7, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # interleaved: channels 0 and 1 are the sine and cosine of one phase
    torch.testing.assert_close(got[..., 0] ** 2 + got[..., 1] ** 2,
                               torch.ones(5, 7))


def test_dgcnn_attn_matches_jax():
    rng = np.random.RandomState(0)
    B, N, C, k = 2, 20, 16, 4
    x = rng.randn(B, N, C).astype(np.float32)
    pos = rng.randn(B, N, C).astype(np.float32)
    model = jax_dgcnn.DGCNNAttn(embed_dims=C, k=k)
    v = perturb_variables(model.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                     jnp.asarray(pos)))
    want = model.apply(jax_vars(v), jnp.asarray(x), jnp.asarray(pos))
    port = load(dgcnn.DGCNNAttn(C, k), weights.dgcnn_attn_state_dict(
        v["params"], v["batch_stats"]))
    # the seed leaves a margin at the k-th distance, for both edge convs
    assert _knn_margin(x + pos, k) > 1e-4
    with torch.no_grad():
        e1 = port.edge_conv(torch.from_numpy(x + pos), port.conv1, port.conv1_bn)
        got = port(torch.from_numpy(x), torch.from_numpy(pos))
    assert _knn_margin(e1.numpy(), k) > 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_knn_takes_the_farthest_points():
    x = torch.tensor([[[0.0, 0.0], [1.0, 0.0], [10.0, 0.0]]])
    idx = dgcnn.knn_farthest(x, 2)
    assert set(idx[0, 0].tolist()) == {2, 1}
    assert set(idx[0, 2].tolist()) == {0, 1}


def _levels(rng, B, C, shapes):
    return [rng.randn(B, h, w, C).astype(np.float32) for h, w in shapes]


def test_bev_cross_attn_matches_jax():
    rng = np.random.RandomState(1)
    B, Q, C = 2, 9, 32
    shapes = [(30, 22), (15, 11), (8, 6), (4, 3)]
    levels = _levels(rng, B, C, shapes)
    q, pos = (rng.randn(B, Q, C).astype(np.float32) for _ in range(2))
    ref = rng.uniform(0.05, 0.95, (B, Q, 2)).astype(np.float32)
    model = jax_dgcnn.BEVDeformableCrossAttn(embed_dims=C, num_heads=4,
                                             num_levels=4, num_points=2)
    args = [jnp.asarray(q), [jnp.asarray(v) for v in levels],
            jnp.asarray(ref), jnp.asarray(pos)]
    v = perturb_variables(model.init(jax.random.PRNGKey(1), *args))
    want = model.apply(jax_vars(v), *args)
    port = load(dgcnn.BEVDeformableCrossAttn(C, 4, 4, 2),
                weights.bev_cross_attn_state_dict(v["params"]))
    with torch.no_grad():
        got = port(torch.from_numpy(q), [torch.from_numpy(a) for a in levels],
                   torch.from_numpy(ref), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_dgcnn_head_matches_jax():
    rng = np.random.RandomState(2)
    jcfg, tcfg = _head_cfgs()
    levels = _levels(rng, 2, 32, [(30, 22), (15, 11), (8, 6), (4, 3)])
    model = jax_dgcnn.DGCNN3DHead(cfg=jcfg, knn_k=4)
    jl = [jnp.asarray(a) for a in levels]
    v = perturb_variables(model.init(jax.random.PRNGKey(2), jl))
    want = model.apply(jax_vars(v), jl)
    port = load(dgcnn.DGCNN3DHead(tcfg, knn_k=4),
                weights.dgcnn_head_state_dict(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = port([torch.from_numpy(a) for a in levels])
    for key in ("all_cls_scores", "all_bbox_preds"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=HEAD_ATOL, err_msg=key)


def _cloud(seed, B=2, P=600, F=5):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-55.0, 55.0, (B, P, F)).astype(np.float32)
    pts[..., 2] = rng.uniform(-6.0, 4.0, (B, P))
    mask = (rng.rand(B, P) > 0.15).astype(np.float32)
    return pts, mask


def test_pillar_encoder_matches_jax():
    pts, mask = _cloud(3)
    model = jax_dgcnn.PillarEncoder(out_channels=8, pc_range=PC, grid_hw=GRID)
    args = [jnp.asarray(pts), jnp.asarray(mask)]
    v = perturb_variables(model.init(jax.random.PRNGKey(3), *args))
    want = jax.jit(model.apply)(jax_vars(v), *args)
    port = load(dgcnn.PillarEncoder(5, 8, PC, GRID),
                weights.pillar_encoder_state_dict(v["params"]))
    with torch.no_grad():
        got = port(torch.from_numpy(pts), torch.from_numpy(mask))
    assert got.shape == (2, *GRID, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("size", [(4, 6), (5, 7), (8, 6)])
def test_same_padding_matches_flax(size):
    """flax 'SAME' on a stride-2 3x3 conv pads (0, 1) on an even size and
    (1, 1) on an odd one."""
    x = np.random.RandomState(4).randn(1, *size, 3).astype(np.float32)
    conv = jax_dgcnn.nn.Conv(5, (3, 3), strides=2)
    v = conv.init(jax.random.PRNGKey(4), jnp.asarray(x))
    want = conv.apply(v, jnp.asarray(x))
    port = dgcnn.Conv2d(3, 5, 3, stride=2)
    port.load_state_dict(weights.to_torch({
        "weight": np.transpose(np.asarray(v["params"]["kernel"]), (3, 2, 0, 1)),
        "bias": np.asarray(v["params"]["bias"])}))
    with torch.no_grad():
        got = dgcnn._conv_nhwc(port, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_nearest_resize_matches_jax():
    """jax.image.resize(method='nearest') at the ratios the FPN meets on odd
    grids, and others where F.interpolate's 'nearest-exact' differs."""
    for m, n in ((8, 15), (15, 30), (6, 11), (11, 22), (3, 6), (20, 25),
                 (22, 41), (14, 23)):
        x = jnp.arange(m, dtype=jnp.float32)[None, :, None, None]
        want = np.asarray(jax.jit(lambda a: jax.image.resize(
            a, (1, n, 1, 1), "nearest"))(x)).reshape(-1)
        got = dgcnn.nearest_indices(m, n).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64), err_msg=(m, n))


def test_second_backbone_and_fpn_match_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(2, *GRID, 8).astype(np.float32)
    bb = jax_dgcnn.SECONDBackbone(channels=(8, 16, 32))
    vb = perturb_variables(bb.init(jax.random.PRNGKey(5), jnp.asarray(x)))
    feats = bb.apply(jax_vars(vb), jnp.asarray(x))
    assert [f.shape[1:3] for f in feats] == [(30, 22), (15, 11), (8, 6)]
    neck = jax_dgcnn.SECONDFPN(out_channels=32, num_outs=4)
    vn = perturb_variables(neck.init(jax.random.PRNGKey(6), feats))
    want = neck.apply(jax_vars(vn), feats)

    pbb = load(dgcnn.SECONDBackbone(8, (8, 16, 32)),
               weights.second_backbone_state_dict(vb["params"]))
    pneck = load(dgcnn.SECONDFPN((8, 16, 32), 32, 4),
                 weights.second_fpn_state_dict(vn["params"], 3))
    with torch.no_grad():
        got_feats = pbb(torch.from_numpy(x))
        got = pneck(got_feats)
    for g, w in zip(got_feats, feats):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


def test_obj_dgcnn_matches_jax_and_decodes_equal():
    pts, mask = _cloud(6)
    jcfg, tcfg = _head_cfgs()
    model = jax_dgcnn.ObjDGCNN(head_cfg=jcfg, grid_hw=GRID, pillar_channels=8,
                               knn_k=4)
    args = [jnp.asarray(pts), jnp.asarray(mask)]
    v = perturb_variables(jax.jit(model.init)(jax.random.PRNGKey(7), *args))
    want = jax.jit(model.apply)(jax_vars(v), *args)
    port = dgcnn.ObjDGCNN(tcfg, GRID, pillar_channels=8, knn_k=4, device="cpu")
    port.load_state_dict(weights.obj_dgcnn_state_dict_from_jax(v), strict=True)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(pts), torch.from_numpy(mask))
    for key in ("all_cls_scores", "all_bbox_preds"):
        assert got[key].shape == want[key].shape == (2, 2, 24, 10)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=HEAD_ATOL, err_msg=key)
    kw = dict(max_num=20, post_center_range=(-61.2, -61.2, -10.0, 61.2, 61.2,
                                             10.0))
    dj = jax_decode(want, **kw)
    dt = decode_batch(got, **kw)
    np.testing.assert_array_equal(dt.labels.numpy(), np.asarray(dj.labels))
    np.testing.assert_array_equal(dt.valid.numpy(), np.asarray(dj.valid))
    np.testing.assert_allclose(dt.bboxes.numpy(), np.asarray(dj.bboxes),
                               rtol=0, atol=HEAD_ATOL * 50)
    np.testing.assert_allclose(dt.scores.numpy(), np.asarray(dj.scores),
                               rtol=0, atol=HEAD_ATOL)


def test_obj_dgcnn_pillar_gradients_match_jax():
    """The LiDAR forward differentiates as the JAX one does: the gradient
    of a fixed random projection of the head's outputs for the pillar
    layers (pfn, pfn_norm), through the head, the FPN, SECOND and K6's
    max-scatter, against jax.grad of the jitted JAX model; the JAX gradient
    tree carried over by the weights mapping. Within 1e-4 of each
    gradient's magnitude."""
    pts, mask = _cloud(6)
    jcfg, tcfg = _head_cfgs()
    model = jax_dgcnn.ObjDGCNN(head_cfg=jcfg, grid_hw=GRID, pillar_channels=8,
                               knn_k=4)
    args = [jnp.asarray(pts), jnp.asarray(mask)]
    v = perturb_variables(jax.jit(model.init)(jax.random.PRNGKey(7), *args))
    rng = np.random.RandomState(8)
    proj = {k: rng.randn(2, 2, 24, 10).astype(np.float32)
            for k in ("all_cls_scores", "all_bbox_preds")}

    def loss_fn(params):
        out = model.apply(jax_vars({**v, "params": params}), *args)
        return sum((out[k] * jnp.asarray(p)).sum() for k, p in proj.items())

    grads = jax.jit(jax.grad(loss_fn))(jax_vars(v["params"]))
    want = weights.obj_dgcnn_state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, grads),
         "batch_stats": v["batch_stats"]})
    port = dgcnn.ObjDGCNN(tcfg, GRID, pillar_channels=8, knn_k=4, device="cpu")
    port.load_state_dict(weights.obj_dgcnn_state_dict_from_jax(v), strict=True)
    port.eval()
    out = port(torch.from_numpy(pts), torch.from_numpy(mask))
    sum((out[k] * torch.from_numpy(p)).sum() for k, p in proj.items()).backward()
    params = dict(port.named_parameters())
    names = [n for n in want if n.startswith("pillar_encoder.")]
    assert len(names) == 4  # pfn and pfn_norm, weight and bias
    for name in names:
        w = want[name].numpy()
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(params[name].grad.numpy(), w, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def test_obj_dgcnn_defaults_are_the_jax_modules():
    model = dgcnn.ObjDGCNN(device="cpu")
    cfg = model.head_cfg
    assert (cfg.num_query, cfg.embed_dims, cfg.num_decoder_layers,
            cfg.num_heads, cfg.num_levels, cfg.num_points, cfg.ffn_dims) == (
                900, 256, 6, 8, 4, 4, 512)
    assert model.pillar_encoder.grid_hw == (128, 128)
    assert model.pts_bbox_head.layer0_self_attn.k == 16
    j = jax_dgcnn.ObjDGCNN(head_cfg=JaxHeadConfig())
    assert (j.grid_hw, j.pillar_channels, j.knn_k) == ((128, 128), 64, 16)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JaxHeadConfig())
