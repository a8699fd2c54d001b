"""PETR-seg (models/petr_seg.py), its BEV map targets (data/pipeline.py::
load_maps and build_batch's `maps`) and its train step against the JAX
package, on the CPU at tiny widths.

Tolerances: atol 1e-4 a function, 2e-4 on raw head outputs (detections
and lane logits), bit-equal host data, the round trip through
tools/convert_checkpoint.py::convert_state_dict exact, and the train step
at tests/test_torch_petr.py's (tests/test_torch_train.py's) tolerances,
with the lane loss `loss_mask` among the metrics.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_data import SRC_HW, FINAL_HW, ann_file, assert_same  # noqa: E402,F401
from tests.test_torch_modules import jax_vars, perturb_variables  # noqa: E402
from tests.test_torch_petr import (HEAD_ATOL, IMG, MTS, assert_round_trip,  # noqa: E402
                                   assert_step_matches_jax, extras,
                                   head_config, jax_model, petr_config)

import graph_detr4d_tpu.configs as jax_configs  # noqa: E402
from graph_detr4d_tpu import config as jax_config  # noqa: E402
from graph_detr4d_tpu.data import nuscenes as jax_nusc  # noqa: E402
from graph_detr4d_tpu.data import pipeline as jax_pipe  # noqa: E402
from graph_detr4d_tpu.data.synthetic import synthetic_batch  # noqa: E402
from graph_detr4d_tpu.models import petr_seg as jax_seg  # noqa: E402
import graph_detr4d_tpu_torch.configs as port_configs  # noqa: E402
from graph_detr4d_tpu_torch import config as port_config  # noqa: E402
from graph_detr4d_tpu_torch import weights  # noqa: E402
from graph_detr4d_tpu_torch.data import nuscenes as port_nusc  # noqa: E402
from graph_detr4d_tpu_torch.data import pipeline as port_pipe  # noqa: E402
from graph_detr4d_tpu_torch.models import petr_seg  # noqa: E402
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D  # noqa: E402

ATOL = 1e-4


def seg_map(seed, hw=(64, 64)):
    """A (H, W, 3) 0/1 map mask with a few filled blobs."""
    rng = np.random.RandomState(seed)
    m = np.zeros((*hw, 3), np.float32)
    for c in range(3):
        for _ in range(4):
            y, x = rng.randint(0, hw[0] - 8), rng.randint(0, hw[1] - 8)
            m[y:y + rng.randint(2, 9), x:x + rng.randint(2, 9), c] = 1.0
    return m


# ------------------------------------------------------------ functions
def test_pos2posemb2d_and_lane_grid_match_jax():
    np.testing.assert_array_equal(petr_seg.lane_grid(16),
                                  jax_seg.lane_grid(16))
    pos = np.random.RandomState(0).rand(5, 2).astype(np.float32)
    want = jax_seg.pos2posemb2d(jnp.asarray(pos), 16)
    got = petr_seg.pos2posemb2d(torch.from_numpy(pos), 16)
    assert got.shape == (5, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    # y first: swapping x and y swaps the halves
    swapped = petr_seg.pos2posemb2d(torch.from_numpy(pos[:, ::-1].copy()), 16)
    torch.testing.assert_close(swapped[:, :16], got[:, 16:])


def test_patches_round_trip_and_match_jax():
    gt = seg_map(1).transpose(2, 0, 1)
    got = petr_seg.maps_to_patches(gt)
    np.testing.assert_array_equal(got, jax_seg.maps_to_patches(gt))
    assert got.shape == (16, 768)
    back = petr_seg.patches_to_map(torch.from_numpy(got))
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jax_seg.patches_to_map(jnp.asarray(got))))
    np.testing.assert_array_equal(back.numpy(), gt)


def test_lane_mask_loss_and_seg_iou_match_jax():
    rng = np.random.RandomState(2)
    logits = (rng.randn(2, 16, 768) * 3).astype(np.float32)
    targets = np.stack([petr_seg.maps_to_patches(
        seg_map(s).transpose(2, 0, 1)) for s in (3, 4)])
    targets[0, 0] = 0.0  # a row without positives: pos_weight = #neg / 1
    want = jax.vmap(jax_seg.lane_mask_loss)(jnp.asarray(logits),
                                            jnp.asarray(targets)).mean()
    got = petr_seg.lane_mask_loss(torch.from_numpy(logits),
                                  torch.from_numpy(targets))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    pred = torch.sigmoid(torch.from_numpy(logits[0].reshape(3, -1)))
    tgt = targets[0].reshape(3, -1)
    np.testing.assert_allclose(
        petr_seg.seg_iou(pred, torch.from_numpy(tgt)).numpy(),
        np.asarray(jax_seg.seg_iou(jnp.asarray(pred.numpy()), jnp.asarray(tgt))),
        rtol=0, atol=ATOL)


# ----------------------------------------------------------------- head
@pytest.mark.parametrize("with_se,with_time", [(True, True), (False, False)])
def test_petr_head_seg_matches_jax(with_se, with_time):
    rng = np.random.RandomState(3)
    B, N, H, W, CIN = 2, 4, 4, 5, 24
    feat = rng.randn(B, N, H, W, CIN).astype(np.float32)
    l2i = (rng.randn(B, N, 4, 4) + 3 * np.eye(4)).astype(np.float32)
    jcfg = head_config(jax_config)
    mod = jax_seg.PETRHeadSeg(cfg=jcfg, img_shape=IMG,
                              position_range=jcfg.petr_position_range,
                              lid=jcfg.petr_lid, with_time=with_time,
                              with_se=with_se)
    jargs = ([jnp.asarray(feat)], jnp.asarray(l2i))
    mts = jnp.asarray(MTS)
    v = perturb_variables(mod.init(jax.random.PRNGKey(0), *jargs,
                                   mean_time_stamp=mts))
    want = mod.apply(jax_vars(v), *jargs, mean_time_stamp=mts)

    port = petr_seg.PETRHeadSeg(head_config(port_config), IMG, CIN,
                                with_time=with_time, with_se=with_se)
    port.load_state_dict(weights.to_torch(
        weights.petr_head_state_dict(v["params"])), strict=True)
    with torch.no_grad():
        got = port([torch.from_numpy(feat)], torch.from_numpy(l2i),
                   mean_time_stamp=torch.from_numpy(MTS))
    assert got["all_lane_preds"].shape == (2, B, 16, 768)
    for k in ("all_cls_scores", "all_bbox_preds", "all_lane_preds"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=HEAD_ATOL, err_msg=k)


def test_seg_state_dict_round_trips_and_aliases_the_lane_branch():
    jcfg = petr_config(jax_config, "petr_seg")
    _, v = jax_model(jcfg, synthetic_batch(jcfg, batch_size=1, seed=0))
    sd = assert_round_trip(v, jcfg)
    port = GraphDETR4D(petr_config(port_config, "petr_seg"), device="cpu")
    assert set(port.state_dict()) == set(sd)
    hd = "pts_bbox_head"
    np.testing.assert_array_equal(sd[f"{hd}.lane_branches.0.4.weight"],
                                  sd[f"{hd}.lane_branches.1.4.weight"])
    assert f"{hd}.transformer_lane.decoder.post_norm.weight" in sd
    assert f"{hd}.se.conv_expand.weight" in sd


# ----------------------------------------------------------------- data
def test_load_maps_matches_jax(tmp_path):
    path = str(tmp_path / "map.npz")
    np.savez(path, seg_map(5, (256, 256)))
    got, want = port_pipe.load_maps(path), jax_pipe.load_maps(path)
    assert_same(got, want)
    assert got[0].shape == (3, 256, 256) and got[1].shape == (256, 768)


@pytest.mark.parametrize("training", [False, True])
def test_build_batch_with_maps_matches_jax(ann_file, tmp_path, training):
    """A petrv2_BEVseg batch (BGR, caffe means and std, no photometric
    distortion), its samples naming map files: bit-equal to JAX's."""
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"map{i}.npz"))
        np.savez(paths[-1], seg_map(10 + i, (64, 64)))
    batches = []
    for configs, nusc, pipe in ((port_configs, port_nusc, port_pipe),
                                (jax_configs, jax_nusc, jax_pipe)):
        cfg = configs.get_config("petrv2_BEVseg")
        ds = nusc.NuScenesSweepDataset(ann_file, load_interval=1, seed=1)
        samples = [dict(ds.sample(i), map_filename=p)
                   for i, p in zip((0, 2), paths)]
        batches.append(pipe.build_batch(
            samples, FINAL_HW, training=training,
            rng=np.random.RandomState(7), src_hw=SRC_HW, aug=cfg.train,
            img_norm=(cfg.img_mean, cfg.img_std, cfg.img_bgr)))
    assert_same(*batches)
    assert batches[0]["maps"].shape == (2, 16, 768)
    assert "mean_time_stamp" in batches[0]


# ---------------------------------------------------------------- train
def test_seg_train_step_matches_jax():
    """PETR-seg over R50-DCN and a CPFPN, temporal, with map targets."""
    jcfg = petr_config(jax_config, "petr_seg", depth=50)
    tcfg = petr_config(port_config, "petr_seg", depth=50)
    batch = dict(synthetic_batch(jcfg, batch_size=1, seed=0, num_gt=5),
                 **extras(jcfg))
    batch["maps"] = petr_seg.maps_to_patches(
        seg_map(6).transpose(2, 0, 1))[None]
    got = assert_step_matches_jax(jcfg, tcfg, batch)
    assert float(got["loss_mask"]) > 0 and "mean_time_stamp" in batch
