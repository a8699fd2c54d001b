"""`head.fix_offset` training: the port against the JAX package, fp32 on
the CPU with the kernels' plain versions, tiny config, dropout 0 and the
grid mask off.

The JAX cross-attention applies stop_gradient to its sampling-offset
Dense and leaves it in AdamW's `main` group, so one step decays it and
nothing else: p1 = p0 (1 - lr_0 wd), lr_0 the schedule's first rate.
  * one TrainStep against JAX's build_train_step from the same weights
    (port init, read into JAX by tools/convert_checkpoint.py): the
    offsets' update is that pure decay within 1e-6 relative and equal to
    JAX's, their gradient 0; the losses within 1e-4 relative, grad_norm
    within 1e-4, every other parameter within 2 lr of JAX's (Adam's first
    update is about lr * sign(g): a gradient near 0 may flip);
  * the offsets keep the `main` label and sit in AdamW's main group;
  * one DistillStep on a tiny MixDistill bundle with the student's
    fix_offset: the student's offsets decay purely, its other head
    parameters move.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tools.convert_checkpoint import convert_state_dict  # noqa: E402

from graph_detr4d_tpu import config as jax_config  # noqa: E402
from graph_detr4d_tpu.models import GraphDETR4D as JaxGraphDETR4D  # noqa: E402
from graph_detr4d_tpu.parallel.step import TrainState, build_train_step  # noqa: E402
from graph_detr4d_tpu.train.optim import build_optimizer  # noqa: E402
from graph_detr4d_tpu_torch import config as port_config  # noqa: E402
from graph_detr4d_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from graph_detr4d_tpu_torch.distill.distiller import (  # noqa: E402
    DistillConfig, Distiller)
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D  # noqa: E402
from graph_detr4d_tpu_torch.train import optim  # noqa: E402
from graph_detr4d_tpu_torch.train.distill_step import DistillStep  # noqa: E402
from graph_detr4d_tpu_torch.train.step import TrainStep  # noqa: E402
from graph_detr4d_tpu_torch.weights import (  # noqa: E402
    init_weights, state_dict_from_jax)

RTOL = 1e-4
OFFSETS = "deform_sampling_offsets"


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several test processes at
    once, and tiny steps gain nothing from more."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def fix_config(c):
    cfg = c.tiny_test_config()
    return dataclasses.replace(
        cfg, head=dataclasses.replace(cfg.head, dropout=0.0, fix_offset=True),
        train=dataclasses.replace(cfg.train, use_grid_mask=False))


def tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def pure_decay(p0, cfg):
    lr0 = cfg.train.lr * optim.lr_factor(cfg.train, 0)
    return p0 * (1.0 - lr0 * cfg.train.weight_decay)


def test_fix_offset_step_is_pure_decay_and_matches_jax():
    cfg, jcfg = fix_config(port_config), fix_config(jax_config)
    model = GraphDETR4D(cfg, device="cpu")
    init_weights(model, 0)
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    batch = synthetic_batch(cfg, 1, seed=0, num_gt=5)

    v = jax.tree_util.tree_map(jnp.asarray, convert_state_dict(
        sd, num_decoder_layers=jcfg.head.num_decoder_layers,
        nheads=jcfg.head.num_heads))
    tx = build_optimizer(jcfg.train)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"],
                       opt_state=tx.init(v["params"]))
    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}
    state, want = jax.jit(build_train_step(JaxGraphDETR4D(jcfg), jcfg))(
        state, jbatch, jax.random.PRNGKey(3))
    want_params = state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, state.params),
         "batch_stats": v["batch_stats"]})

    step = TrainStep(model, cfg)
    got = step.step(tensors(batch))
    for k in ("loss", "loss_cls", "loss_bbox", "d0.loss_cls", "grad_norm"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   err_msg=k)
    lr = cfg.train.lr
    offsets = 0
    for name, p in model.named_parameters():
        after = p.detach().numpy()
        if OFFSETS in name:
            offsets += 1
            assert not p.grad.any(), name
            np.testing.assert_allclose(after, pure_decay(sd[name], cfg),
                                       rtol=1e-6, atol=0, err_msg=name)
            np.testing.assert_allclose(after, want_params[name].numpy(),
                                       rtol=1e-6, atol=0, err_msg=name)
        else:
            np.testing.assert_allclose(after, want_params[name].numpy(),
                                       rtol=0, atol=2 * lr, err_msg=name)
    assert offsets == 2 * cfg.head.num_decoder_layers  # weight and bias


def test_fix_offset_keeps_the_offsets_in_the_main_group():
    model = GraphDETR4D(fix_config(port_config), device="cpu")
    labels = optim.param_labels(model)
    names = [n for n in labels if OFFSETS in n]
    assert names and all(labels[n] == "main" for n in names)
    assert all(p.requires_grad for n, p in model.named_parameters()
               if OFFSETS in n)
    opt, _ = optim.build_optimizer(model, model.cfg.train)
    main = {id(p) for p in opt.param_groups[1]["params"]}
    named = dict(model.named_parameters())
    assert all(id(named[n]) in main for n in names)
    assert opt.param_groups[1]["weight_decay"] == model.cfg.train.weight_decay


def test_fix_offset_distill_step_decays_the_offsets():
    student_cfg = fix_config(port_config)
    teacher_cfg = dataclasses.replace(student_cfg, head=dataclasses.replace(
        student_cfg.head, fix_offset=False))
    teacher = GraphDETR4D(teacher_cfg, device="cpu")
    init_weights(teacher, 0)
    dist = Distiller(student_cfg, teacher_cfg.neck.out_channels, device="cpu")
    init_weights(dist, 1)
    before = {n: p.detach().clone() for n, p in dist.named_parameters()}
    step = DistillStep(teacher, dist, student_cfg, DistillConfig(mix=True),
                       seed=0)
    metrics = step.step(tensors(synthetic_batch(teacher_cfg, 1, seed=2,
                                                num_gt=5)))
    assert np.isfinite(float(metrics["loss"]))
    moved = 0
    for name, p in dist.named_parameters():
        if OFFSETS in name:
            np.testing.assert_allclose(
                p.detach().numpy(), pure_decay(before[name].numpy(),
                                               student_cfg),
                rtol=1e-6, atol=0, err_msg=name)
        elif name.startswith("student.pts_bbox_head.cls_branches"):
            moved += not torch.equal(p, before[name])
    assert moved > 0
