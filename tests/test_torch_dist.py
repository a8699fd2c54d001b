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
  * the MP, DETR3D, DETR3D-v2, PETR, PETRv2 and PETR-seg heads at cam=2
    (3 cameras a rank; MP's camera gate random, so its view quirk shows)
    against one process: every decoder output within 1e-5 absolute plus
    1e-5 relative; PETRv2's decode against the JAX package's own cam=2
    mesh eval step on two virtual CPU devices within 2e-4; one cam=2
    step each of MP and PETRv2 with dropout on (the dense attention's
    weight mask drawn whole and sliced by rank): losses 1e-5 relative,
    grad_norm 1e-4;
  * the dense attention's online-softmax merge of two key halves, run
    by two threads in one process with a thread-backed collective,
    against the one softmax over all keys, with a key mask (one half
    wholly masked) and dropout: 1e-5; the merge without the global row
    max breaks that bound;
  * the test CLI on 2 ranks (samples rank::2, rank 0 merging the partial
    files) against 1 rank on a fixture: identical results and metrics;
  * a 2-rank Trainer (grid mask and dropout on) saved at step 2 and
    resumed to 3 against the uninterrupted run: identical weights; rank
    0 alone logs; the input threads stop;
  * make_mesh_2d's divisibility error, shard_batch's camera slice and TTA
    refusal, shard_cameras accepting every head family and refusing
    ObjDGCNN (no camera axis), the launcher's environment mapping.
"""

import dataclasses
import os
import pickle
import sys
import threading

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
from graph_detr4d_tpu.parallel import mesh as jax_mesh  # noqa: E402
from graph_detr4d_tpu.parallel.step import (  # noqa: E402
    TrainState, build_eval_step, build_train_step)
from graph_detr4d_tpu.train.optim import build_optimizer  # noqa: E402
from graph_detr4d_tpu_torch import config as port_config  # noqa: E402
from graph_detr4d_tpu_torch.data.fixture import write_nuscenes_fixture  # noqa: E402
from graph_detr4d_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from graph_detr4d_tpu_torch.models import transformer as transformer_mod  # noqa: E402
from graph_detr4d_tpu_torch.models.detector import (  # noqa: E402
    CAM_MIXING, GraphDETR4D, shard_cameras)
from graph_detr4d_tpu_torch.models.dgcnn import ObjDGCNN  # noqa: E402
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


# the head families shard_cameras gained beyond Deform3DCrossAttn's:
# (head_type, head fields) on the tiny config (6 cameras, 3 past-frame)
CAM_HEADS = {
    "mp": ("detr4d_pe", dict(attn_type="deform3d_mp")),
    "detr3d": ("detr4d_pe", dict(with_pe=False, attn_type="detr3d")),
    "detr3d_v2": ("detr4d_pe", dict(with_pe=False, attn_type="detr3d_v2")),
    "petr": ("petr", {}),
    "petrv2": ("petrv2", {}),
    "petr_seg": ("petr_seg", {}),
}
CAM_STEPS = ("mp", "petrv2")  # a cam=2 train step each, dropout on
MTS = np.array([0.5], np.float32)  # PETRv2's mean_time_stamp


def cam_head_config(c, name, dropout=0.0):
    """A CAM_HEADS config from either package's config module."""
    head_type, head = CAM_HEADS[name]
    cfg = step_config(c, **head)
    return dataclasses.replace(cfg, head_type=head_type,
                               head=dataclasses.replace(cfg.head,
                                                        dropout=dropout))


def cam_head_batch(cfg, seed):
    batch = synthetic_batch(cfg, 1, seed=seed, num_gt=5)
    if cfg.head_type == "petrv2":
        batch["mean_time_stamp"] = MTS
    return batch


def cam_heads(dropout=0.0, names=tuple(CAM_HEADS)):
    """(cfg, weights, batch) of each CAM_HEADS config, seeded random
    weights (init_weights: MP's camera gate random)."""
    out = {}
    for i, name in enumerate(names):
        cfg = cam_head_config(port_config, name, dropout)
        out[name] = (cfg, random_sd(cfg, 30 + i), cam_head_batch(cfg, 40 + i))
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
        "cam_heads": cam_heads(), "decode": ("petrv2",),
        "cam_steps": cam_heads(dropout=0.1, names=CAM_STEPS),
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


@pytest.mark.parametrize("name", list(CAM_HEADS))
def test_cam_parallel_serves_every_head_family(spec, ranks, name):
    """MP (camera gate random, sliced after its view), DETR3D / DETR3D-v2
    (their per-camera weights and offsets sliced), PETR / PETRv2 /
    PETR-seg (the sine PE over the rig's mask, the dense attention's
    merged softmax): cam=2 against one process, every decoder output."""
    from graph_detr4d_tpu_torch.models.detector import model_extras

    cfg, sd, batch = spec["cam_heads"][name]
    b = tensors(batch)
    with torch.no_grad():
        want = port_model(cfg, sd).eval()(b["images"], b["lidar2img"],
                                          **model_extras(b))
    keys = sorted(k for k in want if k.startswith("all_"))
    assert len(keys) == (3 if name == "petr_seg" else 2)
    for r in ranks:
        got = r["cam_variants"][name]
        assert sorted(k for k in got if k != "decode") == keys
        for k in keys:
            for layer in range(want[k].shape[0]):
                np.testing.assert_allclose(
                    got[k][layer], want[k][layer].numpy(), rtol=1e-5,
                    atol=1e-5, err_msg=f"{name} {k} layer {layer}")


def test_cam_parallel_petrv2_matches_the_jax_cam_mesh(spec, ranks):
    """PETRv2's cam=2 decode on the port's two ranks against the JAX
    package's eval step on a (data 1, cam 2) mesh of two virtual CPU
    devices (tests/test_parallel_cam.py's layout), the same weights
    through tools/convert_checkpoint.py."""
    cfg, sd, batch = spec["cam_heads"]["petrv2"]
    jcfg = cam_head_config(jax_config, "petrv2")
    h = jcfg.head
    v = jax.tree_util.tree_map(jnp.asarray, convert_state_dict(
        sd, num_decoder_layers=h.num_decoder_layers, nheads=h.num_heads))
    mesh = jax_mesh.make_mesh_2d(jax.devices()[:2], cam=2)
    keys = ("images", "lidar2img", "mean_time_stamp")
    sharded = jax_mesh.shard_batch({k: batch[k] for k in keys}, mesh)
    det = build_eval_step(JaxGraphDETR4D(jcfg), jcfg, mesh)(
        v["params"], v["batch_stats"], sharded)
    for r in ranks:
        got = r["cam_variants"]["petrv2"]["decode"]
        for k in ("valid", "labels"):
            np.testing.assert_array_equal(got[k], np.asarray(getattr(det, k)),
                                          err_msg=k)
        for k in ("bboxes", "scores"):
            np.testing.assert_allclose(got[k], np.asarray(getattr(det, k)),
                                       rtol=2e-4, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("name", CAM_STEPS)
def test_cam_parallel_step_with_dropout_matches_one_process(spec, ranks,
                                                           name):
    """One cam=2 step with dropout on against one process from the same
    generator seed: the same dropout bits (the dense attention's (Q, T)
    mask drawn whole, each rank keeping its keys' columns)."""
    cfg, sd, batch = spec["cam_steps"][name]
    assert cfg.head.dropout > 0.0
    (want,), _ = one_process_steps(cfg, sd, batch, 1)
    for r in ranks:
        assert_metrics(r["cam_steps"][name], want, PORT_RTOL, 1e-4,
                       LOSS_KEYS + ("grad_norm",))


class ThreadGroup:
    """A collective over `size` threads of one process: each reduce call
    waits for every thread's value and returns their sum or max."""

    def __init__(self, size):
        self.barrier = threading.Barrier(size, timeout=60)
        self.slots = [None] * size

    def reduce(self, rank, x, op):
        self.slots[rank] = x
        self.barrier.wait()
        out = self.slots[0]
        for y in self.slots[1:]:
            out = op(out, y)
        self.barrier.wait()
        return out


def merged_attention(attn, query, key, value, key_mask, generator_seed,
                     global_max=True):
    """`attn` (a MultiheadAttention) over two halves of the keys, each in
    a thread of its own as one rank of a cam=2 shard, with the module's
    collectives backed by a ThreadGroup; without `global_max` each rank
    stabilises with its own row max. Returns both threads' outputs, with
    no gradient."""
    group = ThreadGroup(2)
    T = key.shape[1] // 2
    outs = [None, None]

    def rank_fn(r):
        shard = Mesh(data=1, cam=2, rank=r, data_group=object(),
                     cam_group=(group, r))
        g = (None if generator_seed is None
             else torch.Generator().manual_seed(generator_seed))
        keys = slice(r * T, (r + 1) * T)
        mask = None if key_mask is None else key_mask[..., keys]
        with torch.no_grad():  # grad mode is a thread's own
            outs[r] = attn(query, key[:, keys], value[:, keys], g, mask,
                           shard=shard)

    def reduce_sum(x, grp):
        return grp[0].reduce(grp[1], x, torch.add)

    def reduce_max(x, grp):
        if not global_max:
            return x.detach()
        return grp[0].reduce(grp[1], x.detach(), torch.maximum)

    real = transformer_mod.all_reduce_sum, transformer_mod.all_reduce_max
    transformer_mod.all_reduce_sum, transformer_mod.all_reduce_max = (
        reduce_sum, reduce_max)
    try:
        threads = [threading.Thread(target=rank_fn, args=(r,))
                   for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        transformer_mod.all_reduce_sum, transformer_mod.all_reduce_max = real
    return outs


def merge_case(seed=0):
    """A MultiheadAttention of width 32 over 4 heads, 12 queries, 2 x 40
    keys whose logits spread over several units (so the halves' row maxima
    differ), a key mask that masks all of the second half for sample 1
    and a few keys of the first half."""
    torch.manual_seed(seed)
    attn = transformer_mod.MultiheadAttention(32, 4, dropout=0.25)
    with torch.no_grad():
        attn.in_proj_weight.normal_(0.0, 0.5)
        attn.in_proj_bias.normal_(0.0, 0.1)
    query = torch.randn(2, 12, 32)
    key = torch.randn(2, 80, 32) * 2.0
    value = torch.randn(2, 80, 32)
    mask = torch.ones(2, 1, 1, 80, dtype=torch.bool)
    mask[1, ..., 40:] = False
    mask[0, ..., 3:7] = False
    return attn, query, key, value, mask


@pytest.mark.parametrize("masked,dropout", [(False, False), (True, False),
                                            (True, True)])
def test_dense_attention_merge_matches_one_softmax(masked, dropout):
    """The online-softmax merge of two key halves (models/transformer.py
    under a camera shard) equals the one softmax over all keys, with a
    key mask (one rank's keys wholly masked for a sample: zeros there,
    no NaN) and with dropout drawn from the same generator."""
    attn, query, key, value, mask = merge_case()
    mask = mask if masked else None
    seed = 7 if dropout else None
    g = None if seed is None else torch.Generator().manual_seed(seed)
    with torch.no_grad():
        want = attn(query, key, value, g, mask)
        outs = merged_attention(attn, query, key, value, mask, seed)
    assert torch.isfinite(want).all()
    for got in outs:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)


def test_dense_attention_merge_needs_the_global_max():
    """The planted fault: each rank stabilising its softmax with its own
    row max mis-scales the halves against each other, far beyond the
    merge's bound of 1e-5; with the key mask, the rank whose keys are all
    masked divides -inf by -inf and gives NaN."""
    attn, query, key, value, mask = merge_case()
    with torch.no_grad():
        want = attn(query, key, value, None, None)
        outs = merged_attention(attn, query, key, value, None, None,
                                global_max=False)
        err = max(float((got - want).abs().max()) for got in outs)
        assert err > 1e-2, err
        outs = merged_attention(attn, query, key, value, mask, None,
                                global_max=False)
        assert not all(torch.isfinite(got).all() for got in outs)


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
    # every head family takes the shard on each module that mixes cameras
    for name in CAM_HEADS:
        model = shard_cameras(GraphDETR4D(
            cam_head_config(port_config, name), device="cpu"), mesh)
        mixing = [m for m in model.modules() if isinstance(m, CAM_MIXING)]
        assert model.pts_bbox_head.cam_shard is mesh
        assert mixing and all(m.cam_shard is mesh for m in mixing), name
    # ObjDGCNN has no camera axis: refused, without citing a queue item
    tiny_head = port_config.tiny_test_config().head
    with pytest.raises(NotImplementedError, match="ObjDGCNN has none") as e:
        shard_cameras(ObjDGCNN(tiny_head, device="cpu"), mesh)
    assert "ROADMAP" not in str(e.value)


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
