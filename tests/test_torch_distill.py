"""The port's distillation (distill/, the head's MixDistill decode,
train/distill_step.py) against the JAX package's, fp32 on the CPU with
the kernels' plain versions.

* each function of distill/losses.py against its JAX twin (1e-5), the
  soft matching's assignments identical;
* instance distillation with reweight_score off and on, with the top-k
  cut, and on planted ties of the teacher's max score (jax.lax.top_k
  keeps the lower index; the port's stable sort must too);
* the guided decode (teacher_query_embed) through the Distiller: student,
  guided and lateral outputs within 2e-4 of the JAX Distiller's;
* one distill step (MixDistill, vanilla feature distillation,
  reweight_score, the top-k cut) on a tiny ResNet-18 teacher and a tiny
  MobileNetV2 student against the JAX step's loss and jax.grad:
  tests/test_torch_train.py's tolerances (losses 1e-4 relative, each
  gradient within 1e-4 of its leaf's magnitude plus twice the port's own
  sensitivity to a 1e-6 change of the images, which only the backbone's
  ReLU kinks make visible);
* distill_loss raising for mix without guided outputs, feat_distill_loss
  on a level mismatch.

Dropout 0 and the grid mask off, so both sides compute the same function.
"""

import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_backbones import tiny_config  # noqa: E402
from tests.test_torch_modules import jax_vars, perturb_variables  # noqa: E402

from graph_detr4d_tpu import config as jax_config  # noqa: E402
from graph_detr4d_tpu.data.synthetic import synthetic_batch  # noqa: E402
from graph_detr4d_tpu.distill import distiller as jax_distiller  # noqa: E402
from graph_detr4d_tpu.distill import losses as jax_losses  # noqa: E402
from graph_detr4d_tpu.models import GraphDETR4D as JaxGraphDETR4D  # noqa: E402
from graph_detr4d_tpu_torch import config as port_config  # noqa: E402
from graph_detr4d_tpu_torch.distill import distiller, losses  # noqa: E402
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D  # noqa: E402
from graph_detr4d_tpu_torch.train.distill_step import DistillStep  # noqa: E402
from graph_detr4d_tpu_torch.weights import (  # noqa: E402
    distiller_state_dict_from_jax, state_dict_from_jax)

RTOL = 1e-4
HEAD_ATOL = 2e-4
O0 = {"xla_backend_optimization_level": "0"}
RNG = np.random.RandomState(0)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_bce_cost_and_soft_bce_match_jax():
    s = RNG.randn(3, 30, 10).astype(np.float32) * 3
    t = RNG.rand(3, 7, 10).astype(np.float32)
    for i in range(3):
        np.testing.assert_allclose(
            losses.bce_cost_matrix(_t(s), _t(t))[i].numpy(),
            np.asarray(jax_losses.bce_cost_matrix(s[i], t[i])), rtol=1e-5,
            atol=1e-5)
    soft = RNG.rand(3, 30, 10).astype(np.float32)
    w = (RNG.rand(3, 30) > 0.5).astype(np.float32)
    avg = np.maximum(w.sum(-1), 1.0)
    got = losses.soft_binary_cross_entropy(_t(s), _t(soft), _t(w), _t(avg))
    for i in range(3):
        np.testing.assert_allclose(
            float(got[i]), float(jax_losses.soft_binary_cross_entropy(
                s[i], soft[i], w[i], avg[i])), rtol=1e-5)


def test_match_soft_targets_matches_jax():
    P, Qs, Qt, C = 4, 40, 12, 10
    sc = RNG.randn(P, Qs, C).astype(np.float32) * 2
    sb = RNG.randn(P, Qs, 10).astype(np.float32)
    ts = RNG.rand(P, Qt, C).astype(np.float32)
    tb = RNG.randn(P, Qt, 10).astype(np.float32)
    got = losses.match_soft_targets(_t(sc), _t(sb), _t(ts), _t(tb))
    assert got.shape == (P, Qt)
    for i in range(P):
        want = np.asarray(jax.jit(jax_losses.match_soft_targets)(
            sc[i], sb[i], ts[i], tb[i]))
        np.testing.assert_array_equal(got[i].numpy(), want)
        assert len(set(want.tolist())) == Qt


@pytest.mark.parametrize("kind", ["vanilla", "attention"])
def test_feat_distill_loss_matches_jax(kind):
    tf = [RNG.randn(2, 3, 5, 7, 8).astype(np.float32),
          RNG.randn(2, 3, 3, 4, 8).astype(np.float32)]
    sf = [RNG.randn(*f.shape).astype(np.float32) for f in tf]
    np.testing.assert_allclose(
        float(losses.feat_distill_loss([_t(f) for f in tf],
                                       [_t(f) for f in sf], kind)),
        float(jax_losses.feat_distill_loss(tf, sf, kind)), rtol=1e-5)
    with pytest.raises(ValueError, match="level mismatch"):
        losses.feat_distill_loss([_t(f) for f in tf], [_t(sf[0])], kind)


def _outs(S, B, Q, C, seed, ties=False):
    rng = np.random.RandomState(seed)
    cls = rng.randn(S, B, Q, C).astype(np.float32) * 2
    if ties:
        # many rows share one max score, as the bf16 teacher gives
        cls = np.round(cls * 2) / 2
    box = rng.randn(S, B, Q, 10).astype(np.float32)
    box[..., 2:4] *= 0.3
    box[..., 5] *= 0.3
    return {"all_cls_scores": cls, "all_bbox_preds": box}


def _torch_outs(o):
    return {k: _t(v) for k, v in o.items()}


@pytest.mark.parametrize("reweight,top_k,ties", [
    (False, None, False), (True, None, False), (True, 16, False),
    (False, 16, True)])
def test_instance_distill_loss_matches_jax(reweight, top_k, ties):
    t = _outs(3, 2, 40, 10, 1, ties)
    s = _outs(3, 2, 40, 10, 2)
    cw = jax_config.HeadConfig().code_weights
    jcfg = jax_distiller.DistillConfig(reweight_score=reweight,
                                       teacher_top_k=top_k)
    pcfg = distiller.DistillConfig(reweight_score=reweight,
                                   teacher_top_k=top_k)
    want = jax.jit(lambda t, s: jax_distiller.instance_distill_loss(
        t, s, cw, jcfg))(t, s)
    got = distiller.instance_distill_loss(_torch_outs(t), _torch_outs(s), cw,
                                          pcfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    if ties:
        scores = jax.nn.sigmoid(t["all_cls_scores"]).max(-1)
        assert (np.unique(np.asarray(scores[0, 0])).size
                < scores.shape[-1] // 2)
        _, want_idx = jax.lax.top_k(scores, top_k)
        got_idx = distiller.top_k_rows(torch.sigmoid(_t(
            t["all_cls_scores"])).max(-1).values, top_k)
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))


def test_distill_loss_raises_for_mix_without_guided_outputs():
    cfg = port_config.tiny_test_config()
    s = _torch_outs(_outs(2, 1, 24, 10, 3))
    t = _torch_outs(_outs(2, 1, 24, 10, 4))
    gt = (torch.zeros(1, 8, 9), torch.zeros(1, 8, dtype=torch.int64),
          torch.zeros(1, 8))
    with pytest.raises(ValueError, match="guided"):
        distiller.distill_loss(s, [], t, [], *gt, cfg,
                               distiller.DistillConfig(mix=True,
                                                       use_feat_distill=False))


def _configs(c):
    """(teacher, student) for the step: tiny ResNet-18 teacher, tiny
    MobileNetV2 student; dropout 0, grid mask off."""
    def fix(cfg):
        return dataclasses.replace(
            cfg, head=dataclasses.replace(cfg.head, dropout=0.0),
            train=dataclasses.replace(cfg.train, use_grid_mask=False))
    return fix(c.tiny_test_config()), fix(tiny_config(c, "mobilenetv2"))


@functools.lru_cache(maxsize=None)
def _setup():
    jt, js = _configs(jax_config)
    batch = synthetic_batch(jt, seed=0, num_gt=5)
    imgs, l2i = jnp.asarray(batch["images"]), jnp.asarray(batch["lidar2img"])
    teacher = JaxGraphDETR4D(jt)
    args = (jax.random.PRNGKey(0), imgs, l2i)
    tv = perturb_variables(jax.jit(teacher.init).lower(*args).compile(O0)(
        *args), seed=1)
    t_qe = jnp.asarray(tv["params"]["head"]["query_embedding"])
    dist = jax_distiller.Distiller(student_cfg=js,
                                   teacher_feat_channels=jt.neck.out_channels)
    init = jax.jit(lambda k, i, l, q: dist.init(k, i, l,
                                                 teacher_query_embed=q))
    dv = perturb_variables(init.lower(jax.random.PRNGKey(1), imgs, l2i,
                                      t_qe).compile(O0)(
        jax.random.PRNGKey(1), imgs, l2i, t_qe), seed=2)
    return jt, js, batch, teacher, tv, dist, dv


def _port_models(tv, dv, device="cpu"):
    jt, js = _configs(port_config)
    teacher = GraphDETR4D(jt, device=device)
    teacher.load_state_dict(state_dict_from_jax(tv), strict=True)
    dist = distiller.Distiller(js, jt.neck.out_channels, device=device)
    dist.load_state_dict(distiller_state_dict_from_jax(dv), strict=True)
    return jt, js, teacher, dist


def test_guided_decode_matches_jax_teacher_query_embed():
    _, _, batch, _, tv, dist, dv = _setup()
    imgs, l2i = jnp.asarray(batch["images"]), jnp.asarray(batch["lidar2img"])
    t_qe = jnp.asarray(tv["params"]["head"]["query_embedding"])
    want_outs, want_adapted = jax.jit(
        lambda v, q: dist.apply(v, imgs, l2i, teacher_query_embed=q))(
        jax_vars(dv), t_qe)
    _, _, teacher, port = _port_models(tv, dv)
    port.eval()
    with torch.no_grad():
        outs, adapted = port(
            torch.from_numpy(batch["images"]), torch.from_numpy(
                batch["lidar2img"]),
            teacher_query_embed=teacher.pts_bbox_head.query_embedding.weight)
    for key in ("all_cls_scores", "all_bbox_preds", "all_cls_scores_guided",
                "all_bbox_preds_guided"):
        np.testing.assert_allclose(outs[key].numpy(),
                                   np.asarray(want_outs[key]), rtol=0,
                                   atol=HEAD_ATOL, err_msg=key)
    assert float(outs["cam_overflow_guided"]) == 0.0
    # the guided decode is not the student's own
    assert not torch.allclose(outs["all_cls_scores"],
                              outs["all_cls_scores_guided"])
    for g, w in zip(adapted, want_adapted):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def _dcfg(mod):
    return mod.DistillConfig(mix=True, use_feat_distill=True,
                             feat_distill_weight=0.1, reweight_score=True,
                             teacher_top_k=16)


def _jax_step(jt, js, batch, teacher, tv, dist, dv):
    """(metrics, gradient tree) of the JAX distill step's loss
    (tools/distill_train.py: _teacher_fwd_body, _student_train_body)."""
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    dcfg = _dcfg(jax_distiller)
    t_qe = jnp.asarray(tv["params"]["head"]["query_embedding"])
    tvars = jax_vars(tv)

    def loss_fn(params, stats):
        t_feats = teacher.apply(tvars, b["images"], False, None,
                                method=JaxGraphDETR4D.extract_feats)
        t_feats = [jax.lax.stop_gradient(f) for f in t_feats]
        t_outs = teacher.apply(tvars, t_feats, b["lidar2img"],
                               method=JaxGraphDETR4D.forward_feats)
        s_outs, adapted = dist.apply(
            {"params": params, "batch_stats": stats}, b["images"],
            b["lidar2img"], train=True, rng=jax.random.PRNGKey(3),
            teacher_query_embed=t_qe, rngs={"dropout": jax.random.PRNGKey(4)})
        return jax_distiller.distill_loss(
            s_outs, adapted, t_outs, t_feats, b["gt_bboxes"], b["gt_labels"],
            b["gt_valid"], js, dcfg)

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    v = jax_vars(dv)
    (_, metrics), grads = fn.lower(v["params"], v["batch_stats"]).compile(O0)(
        v["params"], v["batch_stats"])
    return metrics, grads


def _port_grads(step, batch):
    step.distiller.zero_grad(set_to_none=True)
    t_feats, t_outs = step.teacher_forward(batch)
    total, _, _ = step.student_loss(batch, t_feats, t_outs)
    total.backward()
    return {n: p.grad.clone() for n, p in step.distiller.named_parameters()}


def test_distill_step_matches_jax_loss_and_grad():
    jt, js, batch, teacher, tv, dist, dv = _setup()
    metrics, grads = _jax_step(jt, js, batch, teacher, tv, dist, dv)
    _, pjs, pteacher, pdist = _port_models(tv, dv)
    step = DistillStep(pteacher, pdist, pjs, _dcfg(distiller), seed=0)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    # the port's sensitivity: its gradients at images scaled by 1 + 1e-6
    g0 = _port_grads(step, tb)
    g1 = _port_grads(step, {**tb, "images": tb["images"] * (1 + 1e-6)})
    sens = {n: (g0[n] - g1[n]).abs().max().item() for n in g0}
    got = step.step(tb)
    assert set(metrics) | {"grad_norm"} == set(got)
    for k in ("distill_loss_cls", "distill_loss_reg", "mix_loss_cls",
              "mix_loss_reg", "feat_loss"):
        assert float(metrics[k]) > 0, k
    for k, w in metrics.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=RTOL,
                                   err_msg=k)
    want = distiller_state_dict_from_jax(
        {"params": grads, "batch_stats": dv["batch_stats"]})
    norm = float(np.sqrt(sum(float((np.asarray(g) ** 2).sum())
                             for g in jax.tree_util.tree_leaves(grads))))
    np.testing.assert_allclose(float(got["grad_norm"]), norm, rtol=RTOL)
    clip = js.train.grad_clip_norm
    scale = min(1.0, clip / norm)
    named = dict(step.distiller.named_parameters())
    assert named.keys() <= want.keys()
    for name, p in named.items():
        w = want[name].numpy() * scale
        tol = RTOL * max(float(np.abs(w).max()), 1e-12) + 2 * scale * sens[name]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=tol,
                                   err_msg=name)
        if ".img_backbone." not in name:
            assert sens[name] <= RTOL * np.abs(w).max(), name
    # the teacher took no update and has no gradient
    assert all(p.grad is None for p in step.teacher.parameters())
