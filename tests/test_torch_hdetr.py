"""H-DETR hybrid matching in the port against the JAX package, fp32 on
the CPU (the kernels' plain versions).

* the self-attention with H-DETR's group mask against flax's
  MultiHeadDotProductAttention(mask=...), 1e-5;
* a tiny hybrid GraphDETR4D's four outputs (one2one and one2many logits
  and boxes of every decoder layer) against the JAX model, 2e-4;
* its one2one outputs against a non-hybrid model given the first
  num_query rows of the query embedding (cam_capacity 1.0: no
  compaction whose capacity depends on the query count), 1e-5: the mask
  isolates the groups;
* hybrid_detr3d_loss against JAX's with holes in gt_valid (the tiled GT's
  validity is not a prefix): every metric 1e-5 relative, and both
  groups' per-query targets identical;
* one TrainStep against JAX's build_train_step (dropout and grid mask
  off), as tests/test_torch_train.py does for the flagship.

Tiny configs keep k_one2many x max_gt <= num_query_one2many: K4, like the
JAX solver, takes no more rows than columns.
"""

import dataclasses
import os
import sys

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_modules import jax_vars, perturb_variables  # noqa: E402

from graph_detr4d_tpu import config as jax_config  # noqa: E402
from graph_detr4d_tpu.core.losses import hybrid_detr3d_loss as jax_hybrid_loss  # noqa: E402
from graph_detr4d_tpu.core.matching import match_targets as jax_match  # noqa: E402
from graph_detr4d_tpu.data.synthetic import synthetic_batch  # noqa: E402
from graph_detr4d_tpu.models import GraphDETR4D as JaxGraphDETR4D  # noqa: E402
from graph_detr4d_tpu.parallel.step import TrainState, build_train_step  # noqa: E402
from graph_detr4d_tpu.train.optim import build_optimizer  # noqa: E402
from graph_detr4d_tpu_torch import config as port_config  # noqa: E402
from graph_detr4d_tpu_torch import weights  # noqa: E402
from graph_detr4d_tpu_torch.core.losses import hybrid_detr3d_loss  # noqa: E402
from graph_detr4d_tpu_torch.core.matching import match_targets  # noqa: E402
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D  # noqa: E402
from graph_detr4d_tpu_torch.models.transformer import MultiheadAttention  # noqa: E402
from graph_detr4d_tpu_torch.train.step import TrainStep  # noqa: E402

HEAD_ATOL, ISOLATION_ATOL, LOSS_RTOL, STEP_RTOL = 2e-4, 1e-5, 1e-5, 1e-4
O0 = {"xla_backend_optimization_level": "0"}  # compile time, same program
Q1, Q2, K, MAX_GT = 24, 16, 2, 8  # one2one, one2many queries, k, GT rows


def hybrid_config(c, cam_capacity=0.5, **head_kw):
    """tiny_test_config (ResNet-18, 6 cameras, 64x128, 2 decoder layers)
    with a one2many group of Q2 queries, from either package."""
    cfg = c.tiny_test_config()
    head = dict(num_query=Q1, num_query_one2many=Q2, k_one2many=K,
                lambda_one2many=2.0, dropout=0.0, cam_capacity=cam_capacity)
    head.update(head_kw)
    return dataclasses.replace(
        cfg, head=dataclasses.replace(cfg.head, **head),
        loss=c.LossConfig(max_gt=MAX_GT),
        train=dataclasses.replace(cfg.train, use_grid_mask=False))


def group_mask(q1, q2):
    g = np.arange(q1 + q2) >= q1
    return g[:, None] == g[None, :]


def test_masked_self_attention_matches_flax():
    B, C, heads = 2, 32, 4
    rng = np.random.RandomState(0)
    x = rng.randn(B, Q1 + Q2, C).astype(np.float32)
    mask = group_mask(Q1, Q2)
    mod = flax_nn.MultiHeadDotProductAttention(num_heads=heads)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(x))
    # biases are zero at init: give them noise too
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32) * 0.1,
        v)
    want = mod.apply(v, jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
                     mask=jnp.asarray(mask)[None, None])
    port = MultiheadAttention(C, heads)
    port.load_state_dict(weights.to_torch(weights.mha_state_dict(v["params"])),
                         strict=True)
    with torch.no_grad():
        got = port(*(torch.from_numpy(x),) * 3, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    # the mask matters: without it the answer differs
    with torch.no_grad():
        free = port(*(torch.from_numpy(x),) * 3)
    assert np.abs(free.numpy() - np.asarray(want)).max() > 1e-3


def jax_model(jcfg, batch, seed):
    model = JaxGraphDETR4D(jcfg)
    args = (jax.random.PRNGKey(seed), jnp.asarray(batch["images"]),
            jnp.asarray(batch["lidar2img"]))
    return model, perturb_variables(
        jax.jit(model.init).lower(*args).compile(O0)(*args), seed=seed + 1)


def port_model(tcfg, sd):
    model = GraphDETR4D(tcfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    return model.eval()


def test_hybrid_head_matches_jax():
    jcfg, tcfg = hybrid_config(jax_config), hybrid_config(port_config)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    batch = synthetic_batch(jcfg, seed=0)
    model, v = jax_model(jcfg, batch, seed=3)
    want = jax.jit(model.apply)(jax_vars(v), jnp.asarray(batch["images"]),
                                jnp.asarray(batch["lidar2img"]))
    sd = weights.state_dict_from_jax(v)
    assert sd["pts_bbox_head.query_embedding.weight"].shape[0] == Q1 + Q2
    with torch.no_grad():
        got = port_model(tcfg, sd)(torch.from_numpy(batch["images"]),
                                   torch.from_numpy(batch["lidar2img"]))
    for key in ("all_cls_scores", "all_bbox_preds", "all_cls_scores_one2many",
                "all_bbox_preds_one2many"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=HEAD_ATOL, err_msg=key)
    assert got["all_cls_scores"].shape[2] == Q1
    assert got["all_cls_scores_one2many"].shape[2] == Q2


def test_one2one_group_is_isolated_from_one2many():
    tcfg = hybrid_config(port_config, cam_capacity=1.0)
    plain = dataclasses.replace(tcfg, head=dataclasses.replace(
        tcfg.head, num_query_one2many=0))
    hybrid_model = GraphDETR4D(tcfg, device="cpu")
    weights.init_weights(hybrid_model, seed=5)
    sd = hybrid_model.state_dict()
    # the camera gate's reference quirk (a (B, Q, N) -> (B, N, Q) view, not
    # a transpose) mixes queries unless the gate is the same for every
    # query and camera: zero its projection, as the JAX init does
    for k in sd:
        if "cam_attention_weights" in k:
            sd[k].zero_()
    sd1 = dict(sd)
    key = "pts_bbox_head.query_embedding.weight"
    sd1[key] = sd[key][:Q1].clone()
    batch = synthetic_batch(tcfg, seed=1)
    args = (torch.from_numpy(batch["images"]),
            torch.from_numpy(batch["lidar2img"]))
    with torch.no_grad():
        got = hybrid_model.eval()(*args)
        want = port_model(plain, sd1)(*args)
    for k in ("all_cls_scores", "all_bbox_preds"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=ISOLATION_ATOL, err_msg=k)


def loss_inputs(seed=0, layers=2, B=2):
    rng = np.random.RandomState(seed)
    cfg = hybrid_config(jax_config)
    batch = synthetic_batch(cfg, batch_size=B, seed=seed, num_gt=6)
    valid = batch["gt_valid"].astype(bool)
    valid[0, 1] = valid[1, 4] = False  # holes: validity is not a prefix
    preds = {
        "all_cls_scores": rng.randn(layers, B, Q1, 10).astype(np.float32),
        "all_bbox_preds": rng.randn(layers, B, Q1, 10).astype(np.float32) * .5,
        "all_cls_scores_one2many": rng.randn(layers, B, Q2, 10).astype(
            np.float32),
        "all_bbox_preds_one2many": rng.randn(layers, B, Q2, 10).astype(
            np.float32) * .5,
    }
    return cfg, preds, batch["gt_bboxes"], batch["gt_labels"], valid


def jax_targets(cls, bbox, gt_b, gt_l, gt_v, cfg):
    fn = jax.vmap(jax.vmap(
        lambda c, b, gb, gl, gv: jax_match(
            c, b, gb, gl, gv, num_classes=cfg.head.num_classes,
            cls_weight=cfg.loss.match_cls_weight,
            reg_weight=cfg.loss.match_reg_weight),
        in_axes=(0, 0, 0, 0, 0)), in_axes=(0, 0, None, None, None))
    return jax.jit(fn)(cls, bbox, gt_b, gt_l, gt_v)


def test_hybrid_loss_matches_jax_with_holes_in_gt_valid():
    cfg, preds, gt_b, gt_l, gt_v = loss_inputs()
    assert not all(np.all(np.diff(v.astype(int)) <= 0) for v in gt_v)
    want_total, want = jax.jit(
        lambda p, b, l, v: jax_hybrid_loss(p, b, l, v, cfg.loss, cfg.head)
    )({k: jnp.asarray(a) for k, a in preds.items()}, jnp.asarray(gt_b),
      jnp.asarray(gt_l), jnp.asarray(gt_v))
    t = {k: torch.from_numpy(a) for k, a in preds.items()}
    tcfg = hybrid_config(port_config)
    got_total, got = hybrid_detr3d_loss(
        t, torch.from_numpy(gt_b), torch.from_numpy(gt_l),
        torch.from_numpy(gt_v), tcfg.loss, tcfg.head)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("o2m.") for k in got)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(got_total), float(want_total),
                               rtol=LOSS_RTOL)

    # both groups' assignments: per-query labels, weights and targets
    for suffix, gtk in (("", 1), ("_one2many", K)):
        cls, bbox = preds["all_cls_scores" + suffix], preds[
            "all_bbox_preds" + suffix]
        gb, gl, gv = (np.tile(gt_b, (1, gtk, 1)), np.tile(gt_l, (1, gtk)),
                      np.tile(gt_v, (1, gtk)))
        jt = jax_targets(*(jnp.asarray(a) for a in (cls, bbox, gb, gl, gv)),
                         cfg)
        L = cls.shape[0]
        pt = match_targets(
            torch.from_numpy(cls), torch.from_numpy(bbox),
            *(torch.from_numpy(a)[None].expand(L, *a.shape) for a in (gb, gl, gv)),
            num_classes=tcfg.head.num_classes,
            cls_weight=tcfg.loss.match_cls_weight,
            reg_weight=tcfg.loss.match_reg_weight)
        np.testing.assert_array_equal(pt.labels.numpy(), np.asarray(jt.labels))
        np.testing.assert_array_equal(pt.bbox_weights.numpy(),
                                      np.asarray(jt.bbox_weights))
        np.testing.assert_array_equal(pt.bbox_targets.numpy(),
                                      np.asarray(jt.bbox_targets))
        assert int(pt.bbox_weights.sum()) == L * gtk * int(gt_v.sum())


def test_hybrid_train_step_matches_jax_build_train_step():
    jcfg, tcfg = hybrid_config(jax_config), hybrid_config(port_config)
    batch = synthetic_batch(jcfg, seed=0, num_gt=5)
    model, v = jax_model(jcfg, batch, seed=7)
    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}
    tx = build_optimizer(jcfg.train)
    fresh = jax_vars(v)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=fresh["params"],
                       batch_stats=fresh["batch_stats"],
                       opt_state=tx.init(fresh["params"]))
    rng = jax.random.PRNGKey(3)
    exe = build_train_step(model, jcfg, mesh=None).lower(
        state, jbatch, rng).compile(O0)
    _, want = exe(state, jbatch, rng)

    port = GraphDETR4D(tcfg, device="cpu")
    port.load_state_dict(weights.state_dict_from_jax(v), strict=True)
    got = TrainStep(port, tcfg).step(
        {k: torch.from_numpy(np.asarray(a)) for k, a in batch.items()})
    assert sorted(got) == sorted(want)
    assert "o2m.loss_cls" in got and "o2m.d0.loss_bbox" in got
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=STEP_RTOL, err_msg=k)
