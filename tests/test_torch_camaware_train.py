"""The camera-aware head family's weights, training and CLI against the
JAX package, fp32 on the CPU (the modules and tiny full models are in
tests/test_torch_camaware.py):

* at each registered camera-aware config's full shapes, the port's
  state_dict loads strictly and tools/convert_checkpoint.py::
  convert_state_dict reads DepthNet back as the flax tree holds it;
* a reference-layout checkpoint's dead `depth_net.context_conv` is
  dropped on load;
* one train step with all three extras (cam_aware, the camconv gate,
  scale_pred) against JAX's build_train_step;
* the test CLI on a nuScenes-layout fixture (data/fixture.py) with a
  camera-aware config: the batch's intrinsics and ida_scale reach
  DepthNet, and the answers equal the eval step's on that batch.
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
from tests.test_torch_camaware import (CAMAWARE_CONFIGS, O0,  # noqa: E402
                                       STEP_RTOL, camera_extras, jax_model,
                                       tiny_config)
from tests.test_torch_modules import jax_vars  # noqa: E402
from tools.convert_checkpoint import convert_state_dict  # noqa: E402

from graph_detr4d_tpu import config as jax_config  # noqa: E402
from graph_detr4d_tpu import configs as jax_configs  # noqa: E402
from graph_detr4d_tpu.data.synthetic import synthetic_batch  # noqa: E402
from graph_detr4d_tpu.models import GraphDETR4D as JaxGraphDETR4D  # noqa: E402
from graph_detr4d_tpu.parallel.step import TrainState, build_train_step  # noqa: E402
from graph_detr4d_tpu.train.optim import build_optimizer  # noqa: E402
from graph_detr4d_tpu_torch import config as port_config  # noqa: E402
from graph_detr4d_tpu_torch import configs as port_configs  # noqa: E402
from graph_detr4d_tpu_torch import weights  # noqa: E402
from graph_detr4d_tpu_torch.data.fixture import write_nuscenes_fixture  # noqa: E402
from graph_detr4d_tpu_torch.models import camera_aware  # noqa: E402
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D  # noqa: E402
from graph_detr4d_tpu_torch.train.step import TrainStep  # noqa: E402


@pytest.mark.parametrize("name", CAMAWARE_CONFIGS)
def test_camaware_state_dict_round_trips_convert_state_dict(name):
    """At each registered camera-aware config's full shapes (random arrays
    in flax's tree): every key of state_dict_from_jax loads strictly, and
    convert_state_dict reads back DepthNet's (and every name the JAX tools
    map) as the flax tree holds them; the camconv gate takes the port's
    names."""
    jcfg = jax_configs.get_config(name)
    N, (H, W) = jcfg.head.num_cams, jcfg.img_size
    shapes = jax.eval_shape(JaxGraphDETR4D(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, N, H, W, 3)), jnp.zeros((1, N, 4, 4)))
    rng = np.random.RandomState(12)
    v = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    sd = weights.state_dict_from_jax(v)
    model = GraphDETR4D(port_configs.get_config(name), device="cpu")
    model.load_state_dict(sd, strict=True)
    back = convert_state_dict({k: t.numpy() for k, t in sd.items()})
    if jcfg.head.cam_aware:
        for group in ("params", "batch_stats"):
            want = v[group]["head"]["depth_net"]
            got = back[group]["head"]["depth_net"]
            jax.tree_util.tree_map(np.testing.assert_array_equal, got,
                                   jax.tree_util.tree_map(np.asarray, want))
    for k in ("query_embedding",):
        np.testing.assert_array_equal(back["params"]["head"][k],
                                      v["params"]["head"][k])
    camconv = "pts_bbox_head.fpe.conv_reduce.conv.weight"
    assert (camconv in sd) == (jcfg.head.fpe_type == "camconv")
    if camconv in sd:
        assert sd[camconv].shape == (256, 256 + 6, 1, 1)


def test_reference_checkpoint_drops_dead_context_conv(tmp_path):
    tcfg = tiny_config(port_config, "cam_aware")
    model = GraphDETR4D(tcfg, device="cpu")
    weights.init_weights(model, seed=0)
    sd = dict(model.state_dict())
    sd["pts_bbox_head.depth_net.context_conv.weight"] = torch.zeros(4, 64, 1, 1)
    sd["pts_bbox_head.depth_net.context_conv.bias"] = torch.zeros(4)
    sd["pts_bbox_head.depth_net.reduce_conv.1.num_batches_tracked"] = \
        torch.tensor(3)
    path = str(tmp_path / "ref.pth")
    torch.save({"state_dict": sd, "meta": {}}, path)
    weights.load_reference_checkpoint(path, GraphDETR4D(tcfg, device="cpu"))


def test_train_step_with_extras_matches_jax():
    """cam_aware + the camconv gate + scale_pred: all three extras in the
    batch, one step against the JAX step on the same weights."""
    head = dict(cam_aware=True, fpe_type="camconv", scale_pred=True,
                dropout=0.0)
    cfgs = []
    for c in (jax_config, port_config):
        cfg = c.tiny_test_config()
        cfgs.append(dataclasses.replace(
            cfg, head=dataclasses.replace(cfg.head, **head),
            train=dataclasses.replace(cfg.train, use_grid_mask=False)))
    jcfg, tcfg = cfgs
    batch = synthetic_batch(jcfg, seed=0, num_gt=5)
    batch.update(camera_extras(1, jcfg.head.num_cams, jcfg.img_size, seed=2))
    model, v = jax_model(jcfg, batch, seed=13)
    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}
    tx = build_optimizer(jcfg.train)
    fresh = jax_vars(v)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=fresh["params"],
                       batch_stats=fresh["batch_stats"],
                       opt_state=tx.init(fresh["params"]))
    rng = jax.random.PRNGKey(3)
    _, want = build_train_step(model, jcfg, mesh=None).lower(
        state, jbatch, rng).compile(O0)(state, jbatch, rng)
    port = GraphDETR4D(tcfg, device="cpu")
    port.load_state_dict(weights.state_dict_from_jax(v), strict=True)
    got = TrainStep(port, tcfg).step(
        {k: torch.from_numpy(np.asarray(a)) for k, a in batch.items()})
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=STEP_RTOL, err_msg=k)


def test_cli_feeds_the_camera_extras(tmp_path, monkeypatch):
    from graph_detr4d_tpu_torch.data import pipeline as pipe
    from graph_detr4d_tpu_torch.data.nuscenes import NuScenesSweepDataset
    from graph_detr4d_tpu_torch.parallel.step import build_eval_step
    from graph_detr4d_tpu_torch.tools import test as test_cli

    ann, _ = write_nuscenes_fixture(str(tmp_path / "nusc"), num_samples=2,
                                    src_hw=(90, 160), seed=3)
    opts = ["--tiny", "--cfg-options", "head.num_cams=12",
            "head.num_frame_cams=6", "head.cam_aware=true",
            "head.fpe_type=camconv"]
    seen = []
    inner = camera_aware.DepthNet.forward

    def record(self, x, intrinsics, ida_scale):
        seen.append((intrinsics.clone(), ida_scale.clone()))
        return inner(self, x, intrinsics, ida_scale)

    monkeypatch.setattr(camera_aware.DepthNet, "forward", record)
    out = test_cli.main(opts + ["--device", "cpu", "--ann-file", ann,
                                "--max-samples", "1"])
    assert out["cam_overflow"] == [0.0] and len(out["results"]) == 1
    cfg = test_cli.build_config(test_cli.parse_args(opts))
    s = NuScenesSweepDataset(ann, test_mode=True).sample(0, temporal=True)
    b = pipe.build_batch([s], cfg.img_size, training=False,
                         img_norm=(cfg.img_mean, cfg.img_std, cfg.img_bgr))
    intr, ida = seen[0]
    np.testing.assert_array_equal(intr.numpy(), b["intrinsics"])
    np.testing.assert_array_equal(ida.numpy(), b["ida_scale"])
    assert not np.allclose(b["intrinsics"][..., :2, :2], np.eye(2))
    # the answer equals the eval step's on that batch, with the same
    # seeded weights the CLI draws without --checkpoint
    model = GraphDETR4D(cfg, device="cpu")
    weights.init_weights(model, 0)
    det, _ = build_eval_step(model.eval(), cfg)(
        {k: torch.from_numpy(np.asarray(a)) for k, a in b.items()})
    keep = det.valid[0].numpy()
    np.testing.assert_allclose(np.asarray(out["results"][0]["scores"]),
                               det.scores[0].numpy()[keep], rtol=0, atol=1e-6)
