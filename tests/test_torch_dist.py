"""Data and camera parallelism of the port over torch.distributed on the
CPU: two gloo ranks spawned by parallel/mesh.py::spawn_ranks (each joined
with a timeout, its collectives under a 60 s group timeout), the tiny
config in fp32 with dropout 0 and the grid mask off, against one process
and against the JAX package.

  * data=2, two steps, each rank on one sample of a global batch of 2,
    against the port's one-process TrainStep and JAX's build_train_step
    on the whole batch: losses 1e-4 relative, grad_norm 1e-4 relative
    (1e-3 at the second step against JAX, as tests/test_torch_train.py),
    parameters within 2 lr (Adam's first updates are about lr * sign(g),
    so a gradient near 0 rounded otherwise may flip), ranks identical;
  * a planted uneven batch, every GT on rank 0: the synced step equals
    the one-process step within 1e-5 relative, and leaving out either
    sync point (core/losses.py: the classification avg factor, the L1
    term's positive count) moves the loss or grad_norm by over 1e-2;
  * cam=2 (3 cameras a rank, cam_capacity 0.5, with_detach, the camera
    gate's projection random, not the JAX init's zeros under which every
    gate is 0.5) against data=1: the eval forward's every decoder layer
    within 1e-5, cam_overflow equal, one step as the data case; the
    view quirk is shown to matter for these weights (slicing the gate
    logits by camera before the view gives other gates); the camera-aware
    head (camconv gate, scale_pred) and H-DETR's forward at cam=2 within
    1e-5 absolute plus 1e-5 relative;
  * the test CLI on 2 ranks (samples rank::2, rank 0 merging the partial
    files) against 1 rank on a fixture: identical results and metrics;
  * a 2-rank Trainer (grid mask and dropout on) saved at step 2 and
    resumed to 3 against the uninterrupted run: identical weights; rank
    0 alone logs; the input threads stop;
  * make_mesh_2d's divisibility error, shard_batch's camera slice and TTA
    refusal, the heads camera parallelism refuses, the launcher's
    environment mapping.
"""

import dataclasses
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch_dist_ranks  # noqa: E402
from tools.convert_checkpoint import convert_state_dict  # noqa: E402

from graph_detr4d_tpu import config as jax_config  # noqa: E402
from graph_detr4d_tpu.models import GraphDETR4D as JaxGraphDETR4D  # noqa: E402
from graph_detr4d_tpu.parallel.step import TrainState, build_train_step  # noqa: E402
from graph_detr4d_tpu.train.optim import build_optimizer  # noqa: E402
from graph_detr4d_tpu_torch import config as port_config  # noqa: E402
from graph_detr4d_tpu_torch.data.fixture import write_nuscenes_fixture  # noqa: E402
from graph_detr4d_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from graph_detr4d_tpu_torch.models.detector import (  # noqa: E402
    CAM_PARALLEL_ITEM, GraphDETR4D, shard_cameras)
from graph_detr4d_tpu_torch.parallel.mesh import (  # noqa: E402
    Mesh, make_mesh_2d, shard_batch, spawn_ranks)
from graph_detr4d_tpu_torch.tools import launch_multihost  # noqa: E402
from graph_detr4d_tpu_torch.tools import test as test_cli  # noqa: E402
from graph_detr4d_tpu_torch.train.step import TrainStep  # noqa: E402
from graph_detr4d_tpu_torch.weights import init_weights  # noqa: E402

RTOL = 1e-4
PORT_RTOL = 1e-5  # the port against itself: only the order of sums differs
SPAWN_TIMEOUT_S = 240.0


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several test processes at
    once, and tiny steps gain nothing from more."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def step_config(c, **head):
    cfg = c.tiny_test_config()
    return dataclasses.replace(
        cfg, head=dataclasses.replace(cfg.head, dropout=0.0, **head),
        train=dataclasses.replace(cfg.train, use_grid_mask=False))


def random_sd(cfg, seed):
    model = GraphDETR4D(cfg, device="cpu")
    init_weights(model, seed)
    return {k: v.numpy() for k, v in model.state_dict().items()}


def port_model(cfg, sd):
    return torch_dist_ranks.model_from(cfg, sd)


def tensors(batch):
    return torch_dist_ranks.tensors(batch)


def camera_extras(N, img_hw, seed):
    """Non-identity intrinsics (1, N, 4, 4), the pipeline's ida_scale and
    depth factors (as tests/test_torch_camaware.py makes them)."""
    rng = np.random.RandomState(seed)
    h, w = img_hw
    k = np.tile(np.eye(4, dtype=np.float32), (1, N, 1, 1))
    k[..., 0, 0] = rng.uniform(0.6, 1.4, (1, N)) * w
    k[..., 1, 1] = k[..., 0, 0] * rng.uniform(0.95, 1.05, (1, N))
    k[..., 0, 2] = w / 2 + rng.uniform(-0.1, 0.1, (1, N)) * w
    k[..., 1, 2] = h / 2 + rng.uniform(-0.1, 0.1, (1, N)) * h
    return {"intrinsics": k,
            "ida_scale": np.full((1, N), np.sqrt(2.0) * 0.8, np.float32),
            "depth_factors": rng.uniform(0.7, 1.3, (1,)).astype(np.float32)}


def cam_variants():
    """(cfg, weights, batch) of the camera-aware head (camconv gate,
    scale_pred) and of H-DETR, each at cam_capacity 0.5."""
    out = {}
    for i, (name, head) in enumerate((
            ("camaware", dict(cam_aware=True, fpe_type="camconv",
                              scale_pred=True)),
            ("hdetr", dict(num_query_one2many=48)))):
        cfg = step_config(port_config, cam_capacity=0.5, **head)
        batch = synthetic_batch(cfg, 1, seed=20 + i, num_gt=5)
        if name == "camaware":
            batch.update(camera_extras(cfg.head.num_cams, cfg.img_size, i))
        out[name] = (cfg, random_sd(cfg, 2 + i), batch)
    return out


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    cfg = step_config(port_config)
    batch2 = synthetic_batch(cfg, 2, seed=0, num_gt=5)
    uneven = {k: v.copy() for k, v in batch2.items()}
    uneven["gt_valid"][0] = 1.0  # every GT row of the batch on rank 0
    uneven["gt_valid"][1] = 0.0
    cam_cfg = step_config(port_config, cam_capacity=0.5, with_detach=True)
    train_cfg = port_config.tiny_test_config()  # grid mask and dropout on
    ann, _ = write_nuscenes_fixture(str(root / "nusc"), num_samples=3,
                                    src_hw=(90, 160), seed=11)
    test_argv = ["--tiny", "--device", "cpu", "--ann-file", ann,
                 "--no-temporal", "--max-samples", "3"]
    out = {
        "cfg": cfg, "sd": random_sd(cfg, 0), "batch2": batch2,
        "uneven": uneven, "cam_cfg": cam_cfg, "cam_sd": random_sd(cam_cfg, 1),
        "batch1": synthetic_batch(cam_cfg, 1, seed=3, num_gt=5),
        "train_cfg": train_cfg, "cam_variants": cam_variants(),
        "train_batches": [[synthetic_batch(train_cfg, 1, seed=10 * s + r,
                                           num_gt=4) for r in range(2)]
                          for s in range(3)],
        "test_argv": test_argv + ["--work-dir", str(root / "eval2")],
        "test_argv_one": test_argv + ["--work-dir", str(root / "eval1")],
        "work_dir": str(root / "train"),
    }
    with open(root / "spec.pkl", "wb") as f:
        pickle.dump(out, f)
    out["path"] = str(root / "spec.pkl")
    return out


@pytest.fixture(scope="module")
def ranks(spec):
    """Both ranks' results of every scenario (one spawn of two ranks)."""
    return spawn_ranks(torch_dist_ranks.run, 2, spec["path"],
                       timeout_s=SPAWN_TIMEOUT_S)


def one_process_steps(cfg, sd, batch, steps):
    step = TrainStep(port_model(cfg, sd), cfg)
    metrics = [torch_dist_ranks.floats(step.step(tensors(batch)))
               for _ in range(steps)]
    return metrics, torch_dist_ranks.params(step.model)


def jax_steps(spec, steps):
    jcfg = step_config(jax_config)
    h = jcfg.head
    v = jax.tree_util.tree_map(jnp.asarray, convert_state_dict(
        spec["sd"], num_decoder_layers=h.num_decoder_layers,
        nheads=h.num_heads))
    tx = build_optimizer(jcfg.train)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"],
                       opt_state=tx.init(v["params"]))
    batch = {k: jnp.asarray(a) for k, a in spec["batch2"].items()}
    rng = jax.random.PRNGKey(3)
    exe = build_train_step(JaxGraphDETR4D(jcfg), jcfg, mesh=None).lower(
        state, batch, rng).compile()
    out = []
    for _ in range(steps):
        state, m = exe(state, batch, rng)
        out.append({k: float(x) for k, x in m.items()})
    return out


def assert_metrics(got, want, rtol, grad_norm_rtol, keys=None):
    for k in keys or want:
        tol = grad_norm_rtol if k == "grad_norm" else rtol
        np.testing.assert_allclose(got[k], want[k], rtol=tol, err_msg=k)


LOSS_KEYS = ("loss", "loss_cls", "loss_bbox", "d0.loss_cls", "d0.loss_bbox",
             "num_pos")


def test_data_parallel_matches_one_process_and_jax(spec, ranks):
    want, want_params = one_process_steps(spec["cfg"], spec["sd"],
                                          spec["batch2"], 2)
    jax_want = jax_steps(spec, 2)
    for r in ranks:
        d = r["data"]
        assert d["replica_gap"] == 0.0
        for i, (got, w, j) in enumerate(zip(d["metrics"], want, jax_want)):
            assert_metrics(got, w, RTOL, RTOL, LOSS_KEYS + ("grad_norm",))
            assert_metrics(got, j, RTOL, RTOL if i == 0 else 1e-3,
                           LOSS_KEYS + ("grad_norm",))
    lr = spec["cfg"].train.lr
    got_params = ranks[0]["data"]["params"]
    for name, w in want_params.items():
        np.testing.assert_allclose(got_params[name], w, rtol=0, atol=2 * lr,
                                   err_msg=name)
    # one coalesced all-reduce of every fp32 gradient
    n = sum(w.size for w in want_params.values())
    assert ranks[0]["data"]["reduced_bytes"] == 4 * n


def test_uneven_batch_needs_both_sync_points(spec, ranks):
    (want,), _ = one_process_steps(spec["cfg"], spec["sd"], spec["uneven"], 1)
    for r in ranks:
        u = r["uneven"]
        assert_metrics(u["synced"], want, PORT_RTOL, 1e-4,
                       LOSS_KEYS + ("grad_norm",))
        for variant in ("no_cls_sync", "no_pos_sync"):
            rel = max(abs(u[variant][k] - want[k]) / abs(want[k])
                      for k in ("loss", "grad_norm"))
            assert rel > 1e-2, (variant, rel)


def test_cam_parallel_eval_matches_one_process(spec, ranks):
    model = port_model(spec["cam_cfg"], spec["cam_sd"]).eval()
    b = tensors(spec["batch1"])
    with torch.no_grad():
        want = model(b["images"], b["lidar2img"])
    for r in ranks:
        c = r["cam"]
        assert c["cameras"] == 3
        for key in ("all_cls_scores", "all_bbox_preds"):
            for layer in range(want[key].shape[0]):
                np.testing.assert_allclose(
                    c["forward"][key][layer], want[key][layer].numpy(),
                    rtol=0, atol=1e-5, err_msg=f"{key} layer {layer}")
        assert c["forward"]["cam_overflow"] == float(want["cam_overflow"])


def test_cam_parallel_serves_the_other_deform3d_heads(spec, ranks):
    """The camera-aware head (DepthNet and the camconv gate read each
    camera's intrinsics and ida_scale, shard_batch slices them) and
    H-DETR's two query groups, cam=2 against one process."""
    from graph_detr4d_tpu_torch.models.detector import model_extras

    for name, (cfg, sd, batch) in spec["cam_variants"].items():
        b = tensors(batch)
        with torch.no_grad():
            want = port_model(cfg, sd).eval()(b["images"], b["lidar2img"],
                                              **model_extras(b))
        keys = [k for k in want if k.startswith("all_")]
        assert len(keys) == (4 if name == "hdetr" else 2)
        for r in ranks:
            got = r["cam_variants"][name]
            assert sorted(got) == sorted(keys)
            for k in keys:
                # scale_pred's centres reach |x| ~ 20: 1e-5 relative too
                np.testing.assert_allclose(got[k], want[k].numpy(), rtol=1e-5,
                                           atol=1e-5, err_msg=f"{name} {k}")


def test_cam_parallel_step_matches_one_process(spec, ranks):
    (want,), want_params = one_process_steps(spec["cam_cfg"], spec["cam_sd"],
                                             spec["batch1"], 1)
    lr = spec["cam_cfg"].train.lr
    for r in ranks:
        c = r["cam"]
        assert c["replica_gap"] == 0.0
        assert_metrics(c["metrics"], want, PORT_RTOL, 1e-4,
                       LOSS_KEYS + ("grad_norm",))
    for name, w in want_params.items():
        np.testing.assert_allclose(ranks[0]["cam"]["params"][name], w, rtol=0,
                                   atol=2 * lr, err_msg=name)


def test_gate_view_quirk_shows_with_these_weights(spec):
    """The camera gate of layer 0 for rank 1's cameras, taken after the
    (B, Q, N) -> (B, N, Q) view as the port does, against slicing the
    logits by camera first: with the random gate projection they differ,
    so the cam tests above would catch the wrong order; with the JAX
    init's zero projection every gate is 0.5 and they could not."""
    cfg = spec["cam_cfg"]
    model = port_model(cfg, spec["cam_sd"])
    seen = {}
    attn = model.pts_bbox_head.transformer.decoder.layers[0].attentions[1]
    hook = attn.cam_attention_weights.register_forward_hook(
        lambda m, i, o: seen.setdefault("logits", o.detach()))
    b = tensors(spec["batch1"])
    with torch.no_grad():
        model(b["images"], b["lidar2img"])
    hook.remove()
    logits = seen["logits"]  # (B, Q, N)
    B, Q, N = logits.shape
    right = torch.sigmoid(logits).reshape(B, N, Q)[:, 3:]
    wrong = torch.sigmoid(logits[:, :, 3:]).transpose(1, 2)
    assert (right - wrong).abs().max() > 1e-2
    zero = torch.sigmoid(torch.zeros_like(logits))
    assert torch.equal(zero.reshape(B, N, Q)[:, 3:],
                       zero[:, :, 3:].transpose(1, 2))


def test_test_cli_two_ranks_equal_one(spec, ranks):
    one = test_cli.main(spec["test_argv_one"])
    two = ranks[0]["test_cli"]
    assert len(two["results"]) == 3
    assert two["results"] == one["results"]
    assert two["metrics"] == one["metrics"]
    assert ranks[1]["test_cli"] == {}


def test_resumed_two_rank_trainer_continues(ranks):
    for r in ranks:
        res = r["resume"]
        assert res["step"] == 3 and res["gap"] == 0.0
        assert not res["threads_alive"]
        assert res["log_lines"] == 3  # rank 0's, one line a step


def test_mesh_errors_and_camera_slice():
    with pytest.raises(ValueError, match="not divisible by cam=2"):
        make_mesh_2d(cam=2)  # one process: 1 rank
    mesh = Mesh(data=1, cam=2, rank=1, data_group=object(),
                cam_group=object())
    batch = {"images": np.zeros((1, 6, 4, 4, 3)),
             "lidar2img": np.arange(6)[None, :, None, None] * np.ones(
                 (1, 6, 4, 4)), "depth_factors": np.ones(1),
             "gt_bboxes": np.zeros((1, 5, 9))}
    out = shard_batch(batch, mesh)
    assert out["images"].shape == (1, 3, 4, 4, 3)
    assert out["lidar2img"][0, :, 0, 0].tolist() == [3, 4, 5]
    assert out["depth_factors"] is batch["depth_factors"]
    assert out["gt_bboxes"] is batch["gt_bboxes"]
    with pytest.raises(ValueError, match="TTA"):
        shard_batch({"images": np.zeros((2, 1, 6, 4, 4, 3))}, Mesh())
    # heads whose cameras mix elsewhere than Deform3DCrossAttn's gate
    cfg = port_config.tiny_test_config()
    for bad in (dataclasses.replace(cfg, head_type="petrv2"),
                dataclasses.replace(cfg, head=dataclasses.replace(
                    cfg.head, attn_type="deform3d_mp"))):
        with pytest.raises(NotImplementedError, match=CAM_PARALLEL_ITEM):
            shard_cameras(GraphDETR4D(bad, device="cpu"), mesh)


def test_launcher_maps_flags_to_the_environment():
    args = launch_multihost.parse_args(
        ["train", "--coordinator", "10.0.0.1:29511", "--num-processes", "4",
         "--process-id", "2", "--", "--tiny", "--synthetic"])
    assert args.entry == "train" and args.rest == ["--tiny", "--synthetic"]
    env = launch_multihost.distributed_env(args, {"PATH": "x"})
    assert env == {"PATH": "x", "MASTER_ADDR": "10.0.0.1",
                   "MASTER_PORT": "29511", "WORLD_SIZE": "4", "RANK": "2",
                   "LOCAL_RANK": "0"}
    # without --coordinator: torchrun's environment as it is
    torchrun = {"MASTER_ADDR": "h", "MASTER_PORT": "1", "WORLD_SIZE": "8",
                "RANK": "5", "LOCAL_RANK": "1"}
    args = launch_multihost.parse_args(["test", "--", "--tiny"])
    assert launch_multihost.distributed_env(args, torchrun) == torchrun
    with pytest.raises(SystemExit):
        launch_multihost.parse_args(["train", "--coordinator", "h:1"])
