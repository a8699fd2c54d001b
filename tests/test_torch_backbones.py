"""The port's VoVNet and MobileNetV2 backbones against the JAX package's,
fp32 on the CPU.

* VoVNet V-19-slim-eSE and V-39-eSE (two blocks in stages 4-5: the
  identity add) at an odd input size, where the ceil-mode pool's last
  window is clipped, with and without remat (torch.utils.checkpoint: the
  outputs and the input's gradient equal);
* MobileNetV2 with out_indices (2, 4, 7) (the 1280-channel conv2) and
  (0, 3, 5);
* the reference state_dict the port emits (weights.state_dict_from_jax)
  read back by tools/convert_checkpoint.py::convert_state_dict: the flax
  params and batch_stats exactly;
* a tiny GraphDETR4D with each backbone: raw head outputs within 2e-4;
* the optimizer's labels (train/optim.py::param_labels) against the JAX
  param_label_fn, leaf by leaf, for ResNet, VoVNet, MobileNetV2 and under
  a Distiller's `student.` prefix.

Weights: flax init, the FrozenBN statistics and zero-initialised
projections given seeded noise (tests/test_torch_modules.py), carried by
weights.py. Tolerance: 1e-4 per module (rtol and atol, as the ResNet
test), 2e-4 on raw head outputs.
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
from tests.test_torch_modules import jax_vars, nchw, perturb_variables  # noqa: E402
from tools.convert_checkpoint import convert_state_dict  # noqa: E402

from graph_detr4d_tpu import config as jax_config  # noqa: E402
from graph_detr4d_tpu.data.synthetic import synthetic_batch  # noqa: E402
from graph_detr4d_tpu.distill import Distiller as JaxDistiller  # noqa: E402
from graph_detr4d_tpu.models import GraphDETR4D as JaxGraphDETR4D  # noqa: E402
from graph_detr4d_tpu.models import mobilenet as jax_mobilenet  # noqa: E402
from graph_detr4d_tpu.models import vovnet as jax_vovnet  # noqa: E402
from graph_detr4d_tpu.train.optim import param_label_fn  # noqa: E402
from graph_detr4d_tpu_torch import config as port_config  # noqa: E402
from graph_detr4d_tpu_torch import weights  # noqa: E402
from graph_detr4d_tpu_torch.distill.distiller import Distiller  # noqa: E402
from graph_detr4d_tpu_torch.models import mobilenet, vovnet  # noqa: E402
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D  # noqa: E402
from graph_detr4d_tpu_torch.train.optim import param_labels  # noqa: E402

ATOL = 1e-4
HEAD_ATOL = 2e-4


def _load(module, sd):
    module.load_state_dict(weights.to_torch(sd), strict=True)
    return module.eval()


def _assert_stages(got, want, atol=ATOL):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(
            g.detach().permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=1e-4,
            atol=atol, err_msg=f"stage {i}")


@pytest.mark.parametrize("spec", ["V-19-slim-eSE", "V-39-eSE"])
def test_vovnet_matches_jax_with_and_without_remat(spec):
    # 67 x 93: the pools see 17 x 24, 8 x 12 and 4 x 6, so the ceil-mode
    # pool clips its last window on the even sides
    x = np.random.RandomState(0).randn(2, 67, 93, 3).astype(np.float32)
    model = jax_vovnet.VoVNet(spec_name=spec)
    v = perturb_variables(jax.jit(model.init)(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))
    want = jax.jit(model.apply)(jax_vars(v), jnp.asarray(x))
    sd = weights.vovnet_state_dict(v["params"], v["batch_stats"])
    grads = []
    for remat in (False, True):
        port = _load(vovnet.VoVNet(spec, remat=remat), sd)
        xt = nchw(x).requires_grad_(True)
        got = port(xt)
        _assert_stages(got, want)
        sum((g * g).mean() for g in got).backward()
        grads.append(xt.grad)
    assert [tuple(g.shape[2:]) for g in got] == [(17, 24), (8, 12), (4, 6),
                                                 (2, 3)]
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(), rtol=1e-6,
                               atol=1e-7)
    if spec == "V-39-eSE":
        assert port.stage5.OSA5_2.identity and not port.stage5.OSA5_1.identity


@pytest.mark.parametrize("out_indices", [(2, 4, 7), (0, 3, 5)])
def test_mobilenetv2_matches_jax(out_indices):
    x = np.random.RandomState(1).randn(2, 64, 96, 3).astype(np.float32)
    model = jax_mobilenet.MobileNetV2(out_indices=out_indices)
    v = perturb_variables(jax.jit(model.init)(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))
    want = jax.jit(model.apply)(jax_vars(v), jnp.asarray(x))
    port = _load(mobilenet.MobileNetV2(out_indices),
                 weights.mobilenet_state_dict(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = port(nchw(x))
    _assert_stages(got, want)
    assert hasattr(port, "conv2") == (7 in out_indices)
    if 7 in out_indices:
        assert got[-1].shape[1] == 1280


def tiny_config(c, backbone_type):
    """tiny_test_config's head on a VoVNet V-19-slim-eSE or MobileNetV2,
    from either package's config module."""
    cfg = c.tiny_test_config()
    if backbone_type == "vovnet":
        return dataclasses.replace(
            cfg, backbone_type="vovnet", vovnet_spec="V-19-slim-eSE",
            neck=c.NeckConfig(in_channels=(112, 256, 384, 512),
                              out_channels=64))
    return dataclasses.replace(
        cfg, backbone_type="mobilenetv2",
        backbone=c.BackboneConfig(out_indices=(2, 4, 7)),
        neck=c.NeckConfig(in_channels=(32, 96, 1280), start_level=0,
                          out_channels=64))


def _flat(tree, prefix=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _jax_model(backbone_type, seed=0):
    """(jax cfg, model, perturbed variables, batch), made once a backbone
    for the tests that share it (they only read it)."""
    jcfg = tiny_config(jax_config, backbone_type)
    batch = synthetic_batch(jcfg, seed=seed)
    model = JaxGraphDETR4D(jcfg)
    v = perturb_variables(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(batch["images"]),
        jnp.asarray(batch["lidar2img"])), seed=1)
    return jcfg, model, v, batch


@pytest.mark.parametrize("backbone_type", ["vovnet", "mobilenetv2"])
def test_reference_state_dict_round_trips_through_convert_state_dict(
        backbone_type):
    jcfg, _, v, _ = _jax_model(backbone_type)
    sd = weights.state_dict_from_jax(v)
    back = convert_state_dict({k: t.numpy() for k, t in sd.items()},
                              num_decoder_layers=jcfg.head.num_decoder_layers,
                              nheads=jcfg.head.num_heads)
    for col in ("params", "batch_stats"):
        want, got = dict(_flat(v[col])), dict(_flat(back[col]))
        assert set(got) == set(want), (col, set(got) ^ set(want))
        for path, a in want.items():
            np.testing.assert_array_equal(got[path], a, err_msg=str(path))
    prefix = ("img_backbone.stem.stem_1/conv.weight" if backbone_type == "vovnet"
              else "img_backbone.layer7.0.conv.2.bn.running_var")
    assert prefix in sd


@pytest.mark.parametrize("backbone_type", ["vovnet", "mobilenetv2"])
def test_tiny_detector_matches_jax(backbone_type):
    jcfg, model, v, batch = _jax_model(backbone_type)
    tcfg = tiny_config(port_config, backbone_type)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    imgs, l2i = batch["images"], batch["lidar2img"]
    want = jax.jit(model.apply)(jax_vars(v), jnp.asarray(imgs),
                                jnp.asarray(l2i))
    port = GraphDETR4D(tcfg, device="cpu")
    port.load_state_dict(weights.state_dict_from_jax(v), strict=True)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(imgs), torch.from_numpy(l2i))
    for key in ("all_cls_scores", "all_bbox_preds"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=HEAD_ATOL, err_msg=key)


CODES = {"frozen": 0.0, "backbone": 1.0, "main": 2.0}


def _labelled(shapes):
    """flax variables whose every param leaf holds its JAX label's code."""
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: np.full(s.shape, CODES[param_label_fn(path, s)],
                                np.float32), shapes["params"])
    stats = jax.tree_util.tree_map(lambda s: np.ones(s.shape, np.float32),
                                   shapes["batch_stats"])
    return {"params": params, "batch_stats": stats}


def _assert_labels_match(port, sd):
    labels = param_labels(port)
    assert set(labels.values()) == set(CODES)
    for name, label in labels.items():
        assert torch.unique(sd[name]).tolist() == [CODES[label]], (name, label)
    return [n for n, g in labels.items() if g == "frozen"]


@pytest.mark.parametrize("backbone", ["resnet", "V-39-eSE", "mobilenetv2"])
def test_frozen_labels_match_jax_param_label_fn(backbone):
    def make(c):
        cfg = c.tiny_test_config()
        if backbone == "V-39-eSE":
            return dataclasses.replace(
                cfg, backbone_type="vovnet", vovnet_spec=backbone,
                neck=c.NeckConfig(in_channels=(256, 512, 768, 1024),
                                  out_channels=64))
        return cfg if backbone == "resnet" else tiny_config(c, backbone)

    jcfg = make(jax_config)
    B, N, (H, W) = 1, jcfg.head.num_cams, jcfg.img_size
    shapes = jax.eval_shape(
        JaxGraphDETR4D(jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((B, N, H, W, 3)), jnp.zeros((B, N, 4, 4)))
    sd = weights.state_dict_from_jax(_labelled(shapes))
    frozen = _assert_labels_match(
        GraphDETR4D(make(port_config), device="cpu"), sd)
    if backbone == "V-39-eSE":
        # 3 stem convs and layer 1 of each of the 6 OSA blocks
        assert len(frozen) == 9
        assert "img_backbone.stage5.OSA5_2.layers.1.OSA5_2_1/conv.weight" in frozen
    elif backbone == "mobilenetv2":
        assert frozen == ["img_backbone.conv1.conv.weight"]


def test_frozen_labels_match_jax_under_the_distiller():
    jcfg = tiny_config(jax_config, "vovnet")
    B, N, (H, W) = 1, jcfg.head.num_cams, jcfg.img_size
    C = jcfg.head.embed_dims
    shapes = jax.eval_shape(
        JaxDistiller(student_cfg=jcfg, teacher_feat_channels=48).init,
        jax.random.PRNGKey(0), jnp.zeros((B, N, H, W, 3)),
        jnp.zeros((B, N, 4, 4)),
        teacher_query_embed=jnp.zeros((jcfg.head.num_query, 2 * C)))
    sd = weights.distiller_state_dict_from_jax(_labelled(shapes))
    port = Distiller(tiny_config(port_config, "vovnet"), 48, device="cpu")
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd, strict=True)
    frozen = _assert_labels_match(port, sd)
    assert "student.img_backbone.stem.stem_1/conv.weight" in frozen
    assert param_labels(port)["lateral_convs.0.weight"] == "main"
    assert param_labels(port)[
        "student.img_backbone.stage3.OSA3_1.ese.fc.weight"] == "backbone"
