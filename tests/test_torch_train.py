"""A whole train step of the port against the JAX package's
`parallel/step.py::build_train_step(model, cfg, mesh=None)`, fp32 on the
CPU with the kernels' plain versions.

The flagship's structure at `tests/test_torch_slice.py::slice_config`
(12 cameras, ResNet-50 + DCNv2, 2 decoder layers), 8 padded GT rows of
which 5 are valid, dropout 0 and grid mask off so both sides compute the
same function. Flax initialises the weights, the zero-initialised
projections and FrozenBN statistics get seeded noise, and
weights.state_dict_from_jax carries them over; the JAX gradient tree maps
to port names the same way. Tolerances: loss and per-layer losses 1e-4
relative, grad_norm 1e-4 relative (1e-3 at the second step, see
below), parameters after 2 steps 2 * lr
absolute (Adam's first updates are about lr * sign(g), so a gradient near
0 may flip its sign), and each parameter's gradient 1e-4 of that leaf's
largest |g| plus twice the port's own sensitivity: the most that the
leaf's gradient moves when the input images change by 1e-6 relative,
about the size of the forward difference between the two
implementations. At these tiny widths the backbone's stages 3-4 hold a
few hundred pixels per camera, so a ReLU whose input rounds to the other
side of 0 moves a weight gradient by up to ~1e-2 of its maximum (measured
on the port alone; the JAX-port gap in the backbone is about 1x that
sensitivity). The head's and neck's sensitivity is under 1e-4, so they
are held at 1e-4.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_modules import jax_vars, perturb_variables  # noqa: E402
from tests.test_torch_slice import slice_config  # noqa: E402

from graph_detr4d_tpu import config as jax_config  # noqa: E402
from graph_detr4d_tpu.core.losses import detr3d_loss as jax_detr3d_loss  # noqa: E402
from graph_detr4d_tpu.data.synthetic import synthetic_batch  # noqa: E402
from graph_detr4d_tpu.models import GraphDETR4D as JaxGraphDETR4D  # noqa: E402
from graph_detr4d_tpu.parallel.step import TrainState, build_train_step  # noqa: E402
from graph_detr4d_tpu.train.optim import build_optimizer  # noqa: E402
from graph_detr4d_tpu_torch import config as port_config  # noqa: E402
from graph_detr4d_tpu_torch.core.losses import detr3d_loss  # noqa: E402
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D  # noqa: E402
from graph_detr4d_tpu_torch.train.step import TrainStep  # noqa: E402
from graph_detr4d_tpu_torch.weights import state_dict_from_jax  # noqa: E402

RTOL = 1e-4
O0 = {"xla_backend_optimization_level": "0"}  # compile time, same program


def train_config(c, with_detach=False):
    cfg = slice_config(c)
    return dataclasses.replace(
        cfg,
        head=dataclasses.replace(cfg.head, with_detach=with_detach),
        loss=c.LossConfig(max_gt=8),
        train=dataclasses.replace(cfg.train, use_grid_mask=False),
    )


def setup(with_detach=False):
    """(jax cfg, jax model, perturbed numpy variables, numpy batch, port
    TrainStep on the same weights)."""
    jcfg, tcfg = train_config(jax_config, with_detach), train_config(
        port_config, with_detach)
    batch = synthetic_batch(jcfg, seed=0, num_gt=5)
    model = JaxGraphDETR4D(jcfg)
    args = (jax.random.PRNGKey(0), jnp.asarray(batch["images"]),
            jnp.asarray(batch["lidar2img"]))
    v = perturb_variables(jax.jit(model.init).lower(*args).compile(O0)(*args),
                          seed=1)
    port = GraphDETR4D(tcfg, device="cpu")
    port.load_state_dict(state_dict_from_jax(v), strict=True)
    return jcfg, model, v, batch, TrainStep(port, tcfg)


def jax_grads(jcfg, model, v, batch):
    """(loss, metrics, gradient tree) of the JAX step's loss function."""
    def loss_fn(params):
        out = model.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            batch["images"], batch["lidar2img"], train=True,
            rng=jax.random.PRNGKey(1), rngs={"dropout": jax.random.PRNGKey(2)})
        return jax_detr3d_loss(out, batch["gt_bboxes"], batch["gt_labels"],
                               batch["gt_valid"], jcfg.loss, jcfg.head)

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    params = jax_vars(v)["params"]
    (_, metrics), grads = fn.lower(params).compile(O0)(params)
    return metrics, grads


def port_step(step, batch):
    return step.step({k: torch.from_numpy(np.asarray(a))
                      for k, a in batch.items()})


def port_sensitivity(step, batch, rel=1e-6):
    """|the port's raw gradient at batch - at batch with its images scaled
    by 1 + rel|, per parameter; leaves the parameters as they were."""
    grads = []
    for scale in (1.0, 1.0 + rel):
        b = {k: torch.from_numpy(np.asarray(a)) for k, a in batch.items()}
        b["images"] = b["images"] * scale
        step.model.zero_grad(set_to_none=True)
        out = step.model(b["images"], b["lidar2img"], train=True,
                         generator=step.generator)
        total, _ = detr3d_loss(out, b["gt_bboxes"], b["gt_labels"],
                               b["gt_valid"], step.cfg.loss, step.cfg.head)
        total.backward()
        grads.append({n: p.grad.clone()
                      for n, p in step.model.named_parameters()})
    step.model.zero_grad(set_to_none=True)
    return {n: (grads[0][n] - grads[1][n]).abs().numpy() for n in grads[0]}


def assert_metrics_close(got, want, grad_norm_rtol=RTOL):
    assert sorted(got) == sorted(want) or sorted(got) == sorted(
        list(want) + ["grad_norm"])
    for k in want:
        rtol = grad_norm_rtol if k == "grad_norm" else RTOL
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                                   err_msg=k)


def assert_grads_close(step, grads, stats, scale, sensitivity):
    """The port's gradients after its step (clipped in place by `scale`)
    against the JAX gradient tree, leaf for leaf."""
    want = state_dict_from_jax({"params": grads, "batch_stats": stats})
    named = dict(step.model.named_parameters())
    assert named.keys() <= want.keys()
    for name, p in named.items():
        w = want[name].numpy() * scale
        tol = (RTOL * max(float(np.abs(w).max()), 1e-12)
               + 2 * scale * float(sensitivity[name].max()))
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=tol,
                                   err_msg=name)
        if not name.startswith("img_backbone."):
            assert sensitivity[name].max() <= RTOL * np.abs(w).max(), name


def test_train_step_matches_jax_build_train_step():
    jcfg, model, v, batch, step = setup()
    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}
    tx = build_optimizer(jcfg.train)
    fresh = jax_vars(v)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=fresh["params"],
                       batch_stats=fresh["batch_stats"],
                       opt_state=tx.init(jax_vars(v)["params"]))
    rng = jax.random.PRNGKey(3)
    step_fn = build_train_step(model, jcfg, mesh=None)
    exe = step_fn.lower(state, jbatch, rng).compile(O0)
    state, want1 = exe(state, jbatch, rng)
    state, want2 = exe(state, jbatch, rng)
    metrics, grads = jax_grads(jcfg, model, v, jbatch)

    sensitivity = port_sensitivity(step, batch)
    got1 = port_step(step, batch)
    assert_metrics_close(got1, want1)
    np.testing.assert_allclose(float(got1["loss"]), float(metrics["loss"]),
                               rtol=RTOL)
    norm = float(want1["grad_norm"])
    clip = jcfg.train.grad_clip_norm
    assert norm > clip  # the clip is exercised
    assert_grads_close(step, grads, v["batch_stats"], min(1.0, clip / norm),
                       sensitivity)

    # the second step starts from parameters that differ where Adam's
    # first update (about lr * sign(g)) flipped for a near-zero gradient,
    # which the backbone's ReLU kinks amplify in its gradient norm
    got2 = port_step(step, batch)
    assert_metrics_close(got2, want2, grad_norm_rtol=1e-3)
    want_params = state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, state.params),
         "batch_stats": v["batch_stats"]})
    lr = jcfg.train.lr
    for name, p in step.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want_params[name].numpy(), rtol=0,
                                   atol=2 * lr, err_msg=name)
    stem = "img_backbone.conv1.weight"
    np.testing.assert_array_equal(
        step.model.state_dict()[stem].numpy(),
        state_dict_from_jax(v)[stem].numpy())
