"""The port's train step with `with_detach=True` (level 0 of the past
frame's cameras cut from the gradient) against the JAX package's loss
and gradient, and a short overfit run of the port's Trainer. fp32 on the
CPU with the kernels' plain versions; tolerances as in
test_torch_train.py.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_train import (  # noqa: E402
    assert_grads_close, assert_metrics_close, jax_grads, port_sensitivity,
    port_step, setup)

from graph_detr4d_tpu_torch import config as port_config  # noqa: E402
from graph_detr4d_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D  # noqa: E402
from graph_detr4d_tpu_torch.train.trainer import Trainer  # noqa: E402
from graph_detr4d_tpu_torch.weights import init_weights  # noqa: E402


def test_train_step_with_detach_matches_jax():
    jcfg, model, v, batch, step = setup(with_detach=True)
    metrics, grads = jax_grads(jcfg, model, v,
                               {k: jnp.asarray(a) for k, a in batch.items()})
    sensitivity = port_sensitivity(step, batch)
    got = port_step(step, batch)
    assert_metrics_close({k: g for k, g in got.items() if k != "grad_norm"},
                         metrics)
    norm = float(got["grad_norm"])
    clip = jcfg.train.grad_clip_norm
    assert_grads_close(step, grads, v["batch_stats"], min(1.0, clip / norm),
                       sensitivity)


def test_trainer_overfits_a_fixed_batch(tmp_path):
    """4 steps on one batch with the grid mask and dropout on: the loss
    falls and the frozen stem stays as it was (tests/test_train.py:45 for
    the JAX package)."""
    cfg = port_config.tiny_test_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             lr=1e-3))
    model = GraphDETR4D(cfg, device="cpu")
    init_weights(model, seed=0)
    sd = {k: t.clone() for k, t in model.state_dict().items()}
    batch = synthetic_batch(cfg, batch_size=2, num_gt=4)
    trainer = Trainer(cfg, sd, iter([batch] * 4), str(tmp_path),
                      device="cpu")
    records = trainer.fit(4, log_interval=1)
    trainer.close()
    losses = [r["loss"] for r in records]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert all(np.isfinite(r["grad_norm"]) for r in records)
    assert losses[-1] < losses[0]
    stem = "img_backbone.conv1.weight"
    torch.testing.assert_close(trainer.model.state_dict()[stem], sd[stem],
                               rtol=0, atol=0)
    lines = (tmp_path / "train_log.jsonl").read_text().splitlines()
    assert len(lines) == 4
