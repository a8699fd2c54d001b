"""The port's training pieces (plain kernel versions, CPU, fp32) against the
JAX package's: box encoding, the K1 and K2 gradients, K5 focal loss, K4
assignment, matching targets and the set loss, the grid mask, the LR
schedule and the parameter groups.

Inputs are made with numpy from a seed and given to both sides.
Tolerances: 1e-6 for the box encoding; 1e-5 relative for the focal loss,
the targets and the set loss (the same formulas in another order); 1e-4
for the K1 / K2 gradients, relative to each gradient's magnitude where
that exceeds 1 (the location gradients carry a factor W or H from the
sampling position, whose fp32 rounding on the JAX side the float64 plain
versions do not have); assignments are identical.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_ops import DCN_SIZES, MSDA_LEVELS, _flat, _msda_case  # noqa: E402
from tests.test_torch_slice import slice_config  # noqa: E402

from graph_detr4d_tpu import config as jax_config  # noqa: E402
from graph_detr4d_tpu.core import losses as jax_losses  # noqa: E402
from graph_detr4d_tpu.core import matching as jax_matching  # noqa: E402
from graph_detr4d_tpu.geometry.boxes import normalize_bbox as jax_normalize  # noqa: E402
from graph_detr4d_tpu.models import GraphDETR4D as JaxGraphDETR4D  # noqa: E402
from graph_detr4d_tpu.models.grid_mask import grid_mask as jax_grid_mask  # noqa: E402
from graph_detr4d_tpu.ops import deform_conv as jax_dcn  # noqa: E402
from graph_detr4d_tpu.ops import msda as jax_msda  # noqa: E402
from graph_detr4d_tpu.ops.focal_loss import sigmoid_focal_loss as jax_focal  # noqa: E402
from graph_detr4d_tpu.ops.hungarian import hungarian_assignment as jax_lsa  # noqa: E402
from graph_detr4d_tpu.train.optim import build_lr_schedule, param_label_fn  # noqa: E402
from graph_detr4d_tpu_torch import config as port_config  # noqa: E402
from graph_detr4d_tpu_torch.core import losses, matching  # noqa: E402
from graph_detr4d_tpu_torch.geometry.boxes import normalize_bbox  # noqa: E402
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D  # noqa: E402
from graph_detr4d_tpu_torch.models.grid_mask import (  # noqa: E402
    apply_grid_mask, grid_mask_params)
from graph_detr4d_tpu_torch.ops import deform_conv as dcn_ops  # noqa: E402
from graph_detr4d_tpu_torch.ops import focal_loss as focal_ops  # noqa: E402
from graph_detr4d_tpu_torch.ops import hungarian as lsa_ops  # noqa: E402
from graph_detr4d_tpu_torch.ops import msda as msda_ops  # noqa: E402
from graph_detr4d_tpu_torch.train import optim  # noqa: E402
from graph_detr4d_tpu_torch.weights import state_dict_from_jax  # noqa: E402

GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-5


def assert_grad_close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_RTOL * scale,
                               err_msg=name)


def test_normalize_bbox_matches_jax():
    rng = np.random.RandomState(0)
    boxes = np.concatenate([rng.uniform(-50, 50, (6, 3)),
                            rng.uniform(0.3, 5, (6, 3)),
                            rng.uniform(-np.pi, np.pi, (6, 1)),
                            rng.randn(6, 2)], -1).astype(np.float32)
    boxes[5, 3:6] = 0.0  # a padded GT row: log(0) = -inf on both sides
    for b in (boxes, boxes[:, :7]):
        np.testing.assert_allclose(
            normalize_bbox(torch.from_numpy(b)).numpy(),
            np.asarray(jax_normalize(jnp.asarray(b))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("branch", sorted(MSDA_LEVELS))
def test_msda_gradients_match_jax(branch):
    levels = MSDA_LEVELS[branch]
    values, loc, attn = _msda_case(levels, seed=7)
    g = np.random.RandomState(8).randn(2, loc.shape[1], 32).astype(np.float32)

    def jax_obj(vals, l, a):
        out = jax_msda.multi_scale_deformable_attention(vals, l, a)
        return (out * g).sum()

    want = jax.grad(jax_obj, argnums=(0, 1, 2))(
        [jnp.asarray(v) for v in values], jnp.asarray(loc), jnp.asarray(attn))
    value_t = _flat(values).requires_grad_()
    loc_t = torch.from_numpy(loc).requires_grad_()
    attn_t = torch.from_numpy(attn).requires_grad_()
    out = msda_ops.msda_forward(value_t, levels, loc_t, attn_t)
    (out * torch.from_numpy(g)).sum().backward()
    want_value = np.concatenate(
        [np.asarray(v).reshape(2, -1, *v.shape[3:]) for v in want[0]], 1)
    assert_grad_close(value_t.grad, want_value, "value")
    assert_grad_close(loc_t.grad, want[1], "loc")
    assert_grad_close(attn_t.grad, want[2], "attn")


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("branch", sorted(DCN_SIZES))
def test_deform_conv_gradients_match_jax(branch, stride):
    H, W = DCN_SIZES[branch]
    rng = np.random.RandomState(9)
    B, Cin, Cout = 2, 8, 6
    Ho = dcn_ops.output_size(H, stride, 1)
    Wo = dcn_ops.output_size(W, stride, 1)
    x = rng.randn(B, H, W, Cin).astype(np.float32)
    off = (rng.randn(B, Ho, Wo, 9, 2) * 2.5).astype(np.float32)
    mask = rng.rand(B, Ho, Wo, 9).astype(np.float32)
    w = rng.randn(9, Cin, Cout).astype(np.float32)
    g = rng.randn(B, Ho, Wo, Cout).astype(np.float32)

    def jax_obj(*args):
        return (jax_dcn.deform_conv2d(*args, stride=stride, padding=1) * g).sum()

    want = jax.grad(jax_obj, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, off, mask, w)))
    w_ref = np.ascontiguousarray(
        np.transpose(w.reshape(3, 3, Cin, Cout), (3, 2, 0, 1)))
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, off, mask, w_ref)]
    out = dcn_ops.deform_conv2d(*leaves, stride=stride)
    (out * torch.from_numpy(g)).sum().backward()
    for name, t, wnt in zip(("x", "offsets", "mask"), leaves, want):
        assert_grad_close(t.grad, wnt, name)
    got_w = np.transpose(leaves[3].grad.numpy(), (2, 3, 1, 0)).reshape(
        9, Cin, Cout)
    assert_grad_close(got_w, want[3], "weight")


def test_focal_loss_matches_jax():
    rng = np.random.RandomState(10)
    layers, N, C = 3, 40, 10
    logits = (rng.randn(layers, N, C) * 3).astype(np.float32)
    labels = rng.randint(0, C + 1, (layers, N))
    weights = rng.rand(layers, N).astype(np.float32)
    avg = rng.uniform(1, 20, layers).astype(np.float32)

    def jax_obj(lg):
        return jnp.stack([jax_focal(lg[i], jnp.asarray(labels[i]),
                                    jnp.asarray(weights[i]),
                                    avg_factor=avg[i]) for i in range(layers)])

    want = np.asarray(jax_obj(jnp.asarray(logits)))
    want_grad = np.asarray(jax.grad(lambda lg: jax_obj(lg).sum())(
        jnp.asarray(logits)))
    leaf = torch.from_numpy(logits).requires_grad_()
    got = focal_ops.sigmoid_focal_loss(
        leaf, torch.from_numpy(labels), torch.from_numpy(weights),
        torch.from_numpy(avg))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(leaf.grad.numpy(), want_grad, rtol=0,
                               atol=LOSS_RTOL * np.abs(want_grad).max())


@pytest.mark.parametrize("gamma", [2.0, 1.5])
def test_focal_loss_edge_cases_match_jax(gamma):
    """The plain focal loss against JAX at gamma 2 and 1.5 on three
    layers: logits of +-40 (sigmoid rounds to 0 or 1 in float32, so 1 - p_t
    is exactly 0 for a confident right answer), a layer with no foreground
    label, and a layer whose weights are all 0 (its loss and gradient 0)."""
    rng = np.random.RandomState(11)
    layers, N, C = 3, 40, 10
    logits = (rng.randn(layers, N, C) * 3).astype(np.float32)
    logits[0] = np.where(rng.rand(N, C) < 0.5, 40.0, -40.0)
    labels = rng.randint(0, C + 1, (layers, N))
    labels[0, :C] = np.arange(C)
    logits[0, np.arange(C), np.arange(C)] = 40.0  # right, and confident
    labels[1] = C  # background only
    weights = rng.rand(layers, N).astype(np.float32)
    weights[2] = 0.0
    avg = rng.uniform(1, 20, layers).astype(np.float32)

    def jax_obj(lg):
        return jnp.stack([jax_focal(lg[i], jnp.asarray(labels[i]),
                                    jnp.asarray(weights[i]), gamma=gamma,
                                    avg_factor=avg[i]) for i in range(layers)])

    want = np.asarray(jax_obj(jnp.asarray(logits)))
    want_grad = np.asarray(jax.grad(lambda lg: jax_obj(lg).sum())(
        jnp.asarray(logits)))
    leaf = torch.from_numpy(logits).requires_grad_()
    got = focal_ops.sigmoid_focal_loss(
        leaf, torch.from_numpy(labels), torch.from_numpy(weights),
        torch.from_numpy(avg), gamma=gamma)
    got.sum().backward()
    assert np.isfinite(want).all() and want[2] == 0 and want[1] > 0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(leaf.grad.numpy(), want_grad, rtol=0,
                               atol=LOSS_RTOL * np.abs(want_grad).max())
    assert (leaf.grad[2] == 0).all()


def test_hungarian_matches_jax_and_scipy():
    """Shared costs with ties (rounded), nan / +-inf entries and num_valid
    below R: the JAX op's assignment exactly, and scipy's optimum cost."""
    rng = np.random.RandomState(11)
    P, R, C = 5, 12, 40
    cost = rng.rand(P, R, C).astype(np.float32)
    cost[1] = np.round(cost[1], 1)
    cost[2] = np.round(cost[2] * 2)
    cost[3, 1, 2], cost[3, 4, 5], cost[3, 7, 8] = np.nan, np.inf, -np.inf
    num_valid = np.array([12, 12, 12, 9, 0])
    got = lsa_ops.hungarian_assignment(torch.from_numpy(cost),
                                       torch.from_numpy(num_valid)).numpy()
    for p in range(P):
        want = np.asarray(jax_lsa(jnp.asarray(cost[p]),
                                  num_valid=int(num_valid[p])))
        np.testing.assert_array_equal(got[p], want, err_msg=f"problem {p}")
        n = num_valid[p]
        assert (got[p, n:] == -1).all()
        if n == 0:
            continue
        c = np.nan_to_num(cost[p, :n], nan=100.0, posinf=100.0, neginf=-100.0)
        rows, cols = scipy.optimize.linear_sum_assignment(c)
        np.testing.assert_allclose(c[np.arange(n), got[p, :n]].sum(),
                                   c[rows, cols].sum(), rtol=1e-5)


def _loss_case(seed=12, layers=2, B=2, Q=30, G=8):
    rng = np.random.RandomState(seed)
    cls = rng.randn(layers, B, Q, 10).astype(np.float32) * 2
    bbox = rng.randn(layers, B, Q, 10).astype(np.float32)
    gt = np.zeros((B, G, 9), np.float32)
    gt[..., :3] = rng.uniform(-2, 2, (B, G, 3))
    gt[..., 3:6] = rng.uniform(0.5, 3, (B, G, 3))
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (B, G))
    gt[..., 7:] = rng.randn(B, G, 2)
    labels = rng.randint(0, 10, (B, G)).astype(np.int32)
    valid = np.zeros((B, G), bool)
    valid[0, [0, 2, 3, 6]] = True  # not a prefix: the sort must be stable
    valid[1, :5] = True
    gt[~valid] = 0.0
    return cls, bbox, gt, labels, valid


def test_match_targets_match_jax():
    cls, bbox, gt, labels, valid = _loss_case()
    got = matching.match_targets(
        torch.from_numpy(cls), torch.from_numpy(bbox),
        *(torch.from_numpy(np.broadcast_to(a, (2, *a.shape)).copy())
          for a in (gt, labels, valid)))
    for lyr in range(2):
        for b in range(2):
            want = jax_matching.match_targets(
                jnp.asarray(cls[lyr, b]), jnp.asarray(bbox[lyr, b]),
                jnp.asarray(gt[b]), jnp.asarray(labels[b]),
                jnp.asarray(valid[b]))
            for field in want._fields:
                np.testing.assert_allclose(
                    getattr(got, field)[lyr, b].numpy(),
                    np.asarray(getattr(want, field)), rtol=LOSS_RTOL,
                    err_msg=f"{field} layer {lyr} image {b}")
    cost = matching.hungarian_match_cost(
        torch.from_numpy(cls[0, 0]), torch.from_numpy(bbox[0, 0]),
        torch.from_numpy(gt[0]), torch.from_numpy(labels[0]),
        torch.from_numpy(valid[0]))
    want = jax_matching.hungarian_match_cost(
        jnp.asarray(cls[0, 0]), jnp.asarray(bbox[0, 0]), jnp.asarray(gt[0]),
        jnp.asarray(labels[0]), jnp.asarray(valid[0]))
    np.testing.assert_allclose(cost.numpy(), np.asarray(want), rtol=LOSS_RTOL)


def test_detr3d_loss_and_its_gradient_match_jax():
    cls, bbox, gt, labels, valid = _loss_case(seed=13)
    cfg = jax_config.ModelConfig(loss=jax_config.LossConfig(max_gt=8))
    pcfg = port_config.ModelConfig(loss=port_config.LossConfig(max_gt=8))

    def jax_obj(c, b):
        return jax_losses.detr3d_loss(
            {"all_cls_scores": c, "all_bbox_preds": b}, jnp.asarray(gt),
            jnp.asarray(labels), jnp.asarray(valid), cfg.loss, cfg.head)

    (want_total, want_m), want_g = jax.value_and_grad(
        jax_obj, argnums=(0, 1), has_aux=True)(jnp.asarray(cls),
                                               jnp.asarray(bbox))
    cls_t = torch.from_numpy(cls).requires_grad_()
    bbox_t = torch.from_numpy(bbox).requires_grad_()
    total, metrics = losses.detr3d_loss(
        {"all_cls_scores": cls_t, "all_bbox_preds": bbox_t},
        torch.from_numpy(gt), torch.from_numpy(labels),
        torch.from_numpy(valid), pcfg.loss, pcfg.head)
    total.backward()
    assert sorted(metrics) == sorted(want_m)
    for k in want_m:
        np.testing.assert_allclose(float(metrics[k].detach()), float(want_m[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    for t, w in zip((cls_t, bbox_t), want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=LOSS_RTOL * np.abs(w).max())


def test_grid_mask_matches_jax_draws():
    """apply_grid_mask on the (d, l, st_h, st_w, apply) that JAX's key
    draws gives JAX's mask; grid_mask_params draws in the same ranges."""
    rng = np.random.RandomState(14)
    images = rng.randn(1, 2, 48, 40, 3).astype(np.float32)
    H, prob, ratio = 48, 0.7, 0.5
    applied = set()
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        k_apply, k_d, k_sth, k_stw = jax.random.split(key, 4)
        d = int(jax.random.randint(k_d, (), 2, H))
        l = int(np.clip(int(d * ratio + 0.5), 1, d - 1))
        st_h = int(jax.random.randint(k_sth, (), 0, d))
        st_w = int(jax.random.randint(k_stw, (), 0, d))
        apply = bool(jax.random.uniform(k_apply, ()) < prob)
        applied.add(apply)
        want = np.asarray(jax_grid_mask(key, jnp.asarray(images), prob=prob,
                                        ratio=ratio))
        got = apply_grid_mask(torch.from_numpy(images), d, l, st_h, st_w,
                              apply)
        np.testing.assert_array_equal(got.numpy(), want)
    assert applied == {True, False}
    g = torch.Generator().manual_seed(0)
    for _ in range(50):
        apply, d, l, st_h, st_w = (int(t) for t in grid_mask_params(g, H))
        assert 2 <= d < H and 1 <= l <= max(d - 1, 1)
        assert 0 <= st_h < d and 0 <= st_w < d


def test_lr_schedule_matches_jax():
    tc = port_config.TrainConfig()
    jtc = jax_config.TrainConfig()
    sched = build_lr_schedule(jtc)
    for step in (0, 1, 499, 500, tc.total_steps - 1, tc.total_steps):
        np.testing.assert_allclose(tc.lr * optim.lr_factor(tc, step),
                                   float(sched(step)), rtol=1e-6,
                                   err_msg=f"step {step}")
    # the optimizer's lr at update k is the schedule at k (0-based)
    model = torch.nn.Linear(2, 2)
    opt, sch = optim.build_optimizer(model, tc)
    for step in range(3):
        assert opt.param_groups[1]["lr"] == pytest.approx(
            tc.lr * optim.lr_factor(tc, step), rel=1e-12)
        opt.step()
        sch.step()


def test_param_groups_match_jax_labels():
    """Every port parameter gets the group JAX's param_label_fn gives the
    leaf it comes from: the leaves are filled with their label's code and
    carried over by state_dict_from_jax."""
    jcfg, tcfg = slice_config(jax_config), slice_config(port_config)
    B, N, (H, W) = 1, jcfg.head.num_cams, jcfg.img_size
    shapes = jax.eval_shape(
        JaxGraphDETR4D(jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((B, N, H, W, 3)), jnp.zeros((B, N, 4, 4)))
    codes = {"frozen": 0.0, "backbone": 1.0, "main": 2.0}
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: np.full(s.shape, codes[param_label_fn(path, s)],
                                np.float32), shapes["params"])
    stats = jax.tree_util.tree_map(lambda s: np.ones(s.shape, np.float32),
                                   shapes["batch_stats"])
    sd = state_dict_from_jax({"params": params, "batch_stats": stats})
    port = GraphDETR4D(tcfg, device="cpu")
    groups = {name: optim.param_label(name)
              for name, _ in port.named_parameters()}
    assert set(groups.values()) == set(codes)
    for name, label in groups.items():
        vals = torch.unique(sd[name])
        assert vals.tolist() == [codes[label]], name
    frozen = [n for n, g in groups.items() if g == "frozen"]
    assert "img_backbone.conv1.weight" in frozen
    assert all(n.startswith(("img_backbone.conv1", "img_backbone.layer1"))
               for n in frozen)


def test_train_step_refuses_what_it_does_not_train():
    from graph_detr4d_tpu_torch.train.step import TrainStep

    cfg = port_config.tiny_test_config()
    model = GraphDETR4D(cfg, device="cpu")
    bad = dataclasses.replace(cfg, head=dataclasses.replace(cfg.head,
                                                            fix_offset=True))
    with pytest.raises(NotImplementedError):
        TrainStep(model, bad)
    # the hybrid loss is trained since H-DETR was ported
    hybrid = dataclasses.replace(cfg, head=dataclasses.replace(
        cfg.head, num_query_one2many=16))
    TrainStep(GraphDETR4D(hybrid, device="cpu"), hybrid)
    with pytest.raises(ValueError):
        model(torch.zeros(1, 6, 64, 128, 3), torch.eye(4).expand(1, 6, 4, 4),
              train=True)
    # the PETR family is trained since it was ported: PETRv2 steps, with
    # mean_time_stamp, and every parameter moves or decays
    from graph_detr4d_tpu_torch.data.synthetic import synthetic_batch
    from graph_detr4d_tpu_torch.weights import init_weights

    petr = dataclasses.replace(cfg, head_type="petrv2")
    petr_model = GraphDETR4D(petr, device="cpu")
    init_weights(petr_model, seed=0)
    before = {n: p.detach().clone() for n, p in petr_model.named_parameters()}
    batch = {k: torch.from_numpy(np.asarray(a))
             for k, a in synthetic_batch(petr, seed=0, num_gt=5).items()}
    batch["mean_time_stamp"] = torch.tensor([0.5])
    metrics = TrainStep(petr_model, petr).step(batch)
    assert np.isfinite(float(metrics["loss"]))
    after = dict(petr_model.named_parameters())
    assert all(not torch.equal(p.detach(), before[n])
               for n, p in after.items() if n.startswith("pts_bbox_head."))
    # an FPN level the head does not read only decays, as optax decays it
    tc = petr.train
    lr0 = tc.lr * optim.lr_factor(tc, 0)
    key = "img_neck.fpn_convs.1.conv.weight"
    torch.testing.assert_close(after[key].detach(),
                               before[key] * (1 - lr0 * tc.weight_decay))
