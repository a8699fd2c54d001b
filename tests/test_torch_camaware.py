"""The camera-aware head family of the port against the JAX package, fp32
on the CPU (the kernels' plain versions).

* `cam_coord_channels` at sizes where jax.image.resize's antialiased
  linear kernel shrinks (factors 8, 16 and a non-integer one), 1e-5;
* DepthNet, CAMConv, SELayerCAMConv and the depth_encode cross-attention,
  1e-5;
* a tiny full GraphDETR4D with `cam_aware` (no fpe gate), `cam_aware` +
  `with_fpe`, the `camconv` gate and `scale_pred`, raw head outputs
  within 2e-4, on non-identity intrinsics, ida scales and depth factors;

The weights, a train step with the extras and the test CLI are in
tests/test_torch_camaware_train.py. DepthNet's and the camconv gate's
weights ride on weights.state_dict_from_jax.
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
from tests.test_torch_modules import (ATOL, PC_RANGE, _attn_inputs,  # noqa: E402
                                      _flat_levels, _head_cfg, jax_vars, load,
                                      perturb_variables)

from graph_detr4d_tpu import config as jax_config  # noqa: E402
from graph_detr4d_tpu.data.synthetic import synthetic_batch  # noqa: E402
from graph_detr4d_tpu.models import GraphDETR4D as JaxGraphDETR4D  # noqa: E402
from graph_detr4d_tpu.models import attention as jax_attention  # noqa: E402
from graph_detr4d_tpu.models import camera_aware as jax_cam  # noqa: E402
from graph_detr4d_tpu_torch import config as port_config  # noqa: E402
from graph_detr4d_tpu_torch import weights  # noqa: E402
from graph_detr4d_tpu_torch.models import attention, camera_aware  # noqa: E402
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D  # noqa: E402

MODULE_ATOL, HEAD_ATOL, STEP_RTOL = 1e-5, 2e-4, 1e-4
O0 = {"xla_backend_optimization_level": "0"}  # compile time, same program
SETTINGS = {  # HeadConfig fields of each tiny full model
    "cam_aware": dict(cam_aware=True, with_fpe=False),
    "cam_aware_fpe": dict(cam_aware=True),
    "camconv": dict(fpe_type="camconv"),
    "scale_pred": dict(scale_pred=True),
}
CAMAWARE_CONFIGS = ["detr4d_res50_deform_camaware_pe_aug_2subset_12e",
                    "detr4d_res50_deform_camaware_fpe_2subset_12e",
                    "detr4d_res50_deform_camconvfpe_2subset_12e",
                    "detr4d_res50_deform_simpleda_2subset_12e"]


def camera_extras(B, N, img_hw, seed):
    """Non-identity intrinsics (B, N, 4, 4) of a rig at img_hw, the
    pipeline's ida_scale (sqrt(2)|ida00|, one per sample) and depth
    factors (B,)."""
    rng = np.random.RandomState(seed)
    h, w = img_hw
    k = np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1))
    f = rng.uniform(0.6, 1.4, (B, N)) * w
    k[..., 0, 0] = f
    k[..., 1, 1] = f * rng.uniform(0.95, 1.05, (B, N))
    k[..., 0, 2] = w / 2 + rng.uniform(-0.1, 0.1, (B, N)) * w
    k[..., 1, 2] = h / 2 + rng.uniform(-0.1, 0.1, (B, N)) * h
    ida = np.sqrt(2.0) * rng.uniform(0.4, 1.2, (B, 1)).repeat(N, 1)
    return {"intrinsics": k.astype(np.float32),
            "ida_scale": ida.astype(np.float32),
            "depth_factors": rng.uniform(0.7, 1.3, (B,)).astype(np.float32)}


@pytest.mark.parametrize("feat_hw,img_hw", [((8, 16), (64, 128)),
                                            ((4, 10), (64, 160)),
                                            ((7, 13), (60, 150))])
def test_cam_coord_channels_match_jax(feat_hw, img_hw):
    k = camera_extras(2, 3, img_hw, seed=0)["intrinsics"]
    fx, fy, cx, cy = k[..., 0, 0], k[..., 1, 1], k[..., 0, 2], k[..., 1, 2]
    want = jax.jit(lambda *a: jax_cam.cam_coord_channels(
        *feat_hw, *img_hw, *a))(*(jnp.asarray(a) for a in (fx, fy, cx, cy)))
    got = camera_aware.cam_coord_channels(
        *feat_hw, *img_hw, *(torch.from_numpy(a) for a in (fx, fy, cx, cy)))
    assert got.shape == want.shape == (2, 3, *feat_hw, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=MODULE_ATOL)


def _feat(seed, shape=(2, 3, 6, 10, 16)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_depth_net_matches_jax():
    x = _feat(1)
    ex = camera_extras(2, 3, (48, 80), seed=1)
    jmod = jax_cam.DepthNet(mid_channels=16, context_channels=16)
    args = (jnp.asarray(x), jnp.asarray(ex["intrinsics"]),
            jnp.asarray(ex["ida_scale"]))
    v = perturb_variables(jmod.init(jax.random.PRNGKey(0), *args), seed=2)
    want = jmod.apply(jax_vars(v), *args)
    port = load(camera_aware.DepthNet(16, 16),
                weights.depth_net_state_dict(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(ex["intrinsics"]),
                   torch.from_numpy(ex["ida_scale"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=MODULE_ATOL)


def test_camconv_and_se_camconv_match_jax():
    x, pe = _feat(3), _feat(4)
    k = camera_extras(2, 3, (48, 80), seed=3)["intrinsics"]
    img = (48, 80)
    jconv = jax_cam.CAMConv(out_channels=16, img_shape=img)
    v = jconv.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(k))
    want = jconv.apply(v, jnp.asarray(x), jnp.asarray(k))
    port = camera_aware.CAMConv(16, 16, img)
    w = weights._Writer(v["params"])
    w.conv(["conv"], "conv", bias=True)
    load(port, w.sd)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=MODULE_ATOL)

    jse = jax_cam.SELayerCAMConv(16, img_shape=img)
    v = jse.init(jax.random.PRNGKey(2), jnp.asarray(pe), jnp.asarray(x),
                 jnp.asarray(k))
    port = load(camera_aware.SELayerCAMConv(16, img),
                weights.se_camconv_state_dict(v["params"]))
    for intr in (k, None):  # without intrinsics: the identity
        want = jse.apply(v, jnp.asarray(pe), jnp.asarray(x),
                         None if intr is None else jnp.asarray(intr))
        with torch.no_grad():
            got = port(torch.from_numpy(pe), torch.from_numpy(x),
                       None if intr is None else torch.from_numpy(intr))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=MODULE_ATOL)


def test_depth_encode_cross_attn_matches_jax():
    jcfg, _ = _head_cfg()
    d = _attn_inputs(jcfg, overflow=False, seed=5)
    kw = dict(embed_dims=jcfg.embed_dims, num_heads=jcfg.num_heads,
              num_levels=jcfg.num_levels, num_points=jcfg.num_points,
              num_cams=jcfg.num_cams, pc_range=PC_RANGE,
              cam_capacity=jcfg.cam_capacity, depth_encode=True)
    jmod = jax_attention.Deform3DCrossAttn(dropout=0.0, **kw)
    args = (jnp.asarray(d["query"]), [jnp.asarray(v) for v in d["levels"]],
            jnp.asarray(d["query_pos"]), jnp.asarray(d["ref"]),
            jnp.asarray(d["l2i"]), d["img"])
    v = perturb_variables(jmod.init(jax.random.PRNGKey(5), *args), seed=6)
    want = jmod.apply(jax_vars(v), *args)
    port = attention.Deform3DCrossAttn(**kw)
    assert port.position_encoder[0].in_features == 4
    load(port, weights.cross_attn_state_dict(v["params"]))
    with torch.no_grad():
        got, _ = port(torch.from_numpy(d["query"]), _flat_levels(d["levels"]),
                      d["shapes"], torch.from_numpy(d["query_pos"]),
                      torch.from_numpy(d["ref"]), torch.from_numpy(d["l2i"]),
                      d["img"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=MODULE_ATOL)
    assert ATOL >= MODULE_ATOL


def tiny_config(c, setting, **kw):
    cfg = c.tiny_test_config()
    return dataclasses.replace(cfg, head=dataclasses.replace(
        cfg.head, dropout=0.0, **SETTINGS[setting]), **kw)


def jax_model(jcfg, batch, seed):
    model = JaxGraphDETR4D(jcfg)
    args = (jax.random.PRNGKey(seed), jnp.asarray(batch["images"]),
            jnp.asarray(batch["lidar2img"]))
    return model, perturb_variables(
        jax.jit(model.init).lower(*args).compile(O0)(*args), seed=seed + 1)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_full_model_matches_jax(setting):
    jcfg, tcfg = tiny_config(jax_config, setting), tiny_config(port_config,
                                                               setting)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    batch = synthetic_batch(jcfg, seed=0)
    ex = camera_extras(1, jcfg.head.num_cams, jcfg.img_size, seed=4)
    model, v = jax_model(jcfg, batch, seed=9)
    want = jax.jit(model.apply)(
        jax_vars(v), jnp.asarray(batch["images"]),
        jnp.asarray(batch["lidar2img"]),
        **{k: jnp.asarray(a) for k, a in ex.items()})
    port = GraphDETR4D(tcfg, device="cpu")
    port.load_state_dict(weights.state_dict_from_jax(v), strict=True)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(batch["images"]),
                   torch.from_numpy(batch["lidar2img"]),
                   **{k: torch.from_numpy(a) for k, a in ex.items()})
        # the extras change the answer: they are not ignored
        bare = port(torch.from_numpy(batch["images"]),
                    torch.from_numpy(batch["lidar2img"]))
    for key in ("all_cls_scores", "all_bbox_preds"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=HEAD_ATOL, err_msg=key)
    assert np.abs(got["all_bbox_preds"].numpy()
                  - bare["all_bbox_preds"].numpy()).max() > 1e-3
