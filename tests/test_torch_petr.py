"""The PETR family's modules, heads and detectors (models/petr_head.py, the
CPFPN of models/fpn.py, the neck-less detector) against the JAX package,
fp32 on the CPU at tiny widths.

Weights: flax initialises, tests/test_torch_modules.py::perturb_variables
replaces its zero-initialised projections and FrozenBN statistics with
seeded noise, and weights.py carries them over, loaded with strict=True.
Tolerances: atol 1e-4 a module, 2e-4 on raw head outputs (the JAX
goldens' own, tests/test_golden_full_model.py); the round trip through
tools/convert_checkpoint.py::convert_state_dict exact; the train step at
tests/test_torch_train.py's tolerances (loss and metrics 1e-4 relative,
each gradient 1e-4 of its leaf's largest |g| plus twice the port's own
sensitivity to a 1e-6 relative change of the images, probed along the
images and along a seeded random direction, see `port_sensitivity`).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_modules import jax_vars, perturb_variables  # noqa: E402
from tools.convert_checkpoint import convert_state_dict  # noqa: E402

from graph_detr4d_tpu import config as jax_config  # noqa: E402
from graph_detr4d_tpu.data.synthetic import synthetic_batch  # noqa: E402
from graph_detr4d_tpu.models import GraphDETR4D as JaxGraphDETR4D  # noqa: E402
from graph_detr4d_tpu.models import petr_head as jax_petr  # noqa: E402
from graph_detr4d_tpu.parallel.step import TrainState, build_train_step  # noqa: E402
from graph_detr4d_tpu.train.optim import build_optimizer  # noqa: E402
from graph_detr4d_tpu_torch import config as port_config  # noqa: E402
from graph_detr4d_tpu_torch import weights  # noqa: E402
from graph_detr4d_tpu_torch.models import petr_head  # noqa: E402
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D  # noqa: E402
from graph_detr4d_tpu_torch.train.step import TrainStep  # noqa: E402

ATOL, HEAD_ATOL, RTOL = 1e-4, 2e-4, 1e-4
O0 = {"xla_backend_optimization_level": "0"}  # compile time, same program
IMG = (64, 80)  # the heads' padded network input
MTS = np.array([0.5, 0.25], np.float32)


def head_config(c, **kw):
    return c.HeadConfig(num_query=12, embed_dims=32, num_decoder_layers=2,
                        num_heads=4, num_cams=4, num_frame_cams=2,
                        ffn_dims=64, depth_num=4, pe_num_feats=16,
                        dropout=0.0, with_detach=False, num_lane=16, **kw)


NECKS = {  # neck, backbone out_indices
    "cpfpn": (dict(in_channels=(256, 512), start_level=0, num_outs=2,
                   cp=True), (2, 3)),
    "cpfpn_extra": (dict(in_channels=(256, 512), start_level=0, num_outs=3,
                         cp=True), (2, 3)),
    "c5": (dict(in_channels=(256, 512), start_level=0, num_outs=0, cp=True),
           (3,)),
    "fpn": (dict(in_channels=(64, 128, 256, 512)), (0, 1, 2, 3)),
}


def petr_config(c, head_type="petr", neck="cpfpn", depth=18, **head_kw):
    """A PETR-family detector at tiny width from either package's config
    module: ResNet-18 (or ResNet-50 with DCNv2 on stages 3-4, as
    petr_r50dcn_* and petrv2_res50_*), 4 cameras (2 of them the past
    frame) at 64x128, BGR with caffe means, dropout 0, no grid mask."""
    n, out_indices = NECKS[neck]
    if depth == 50:  # ResNet-50's channels
        n = dict(n, in_channels=tuple(4 * ch for ch in n["in_channels"]))
    return c.ModelConfig(
        head_type=head_type,
        backbone=c.BackboneConfig(depth=depth, use_dcn=depth == 50,
                                  out_indices=out_indices),
        neck=c.NeckConfig(out_channels=32, **n),
        head=head_config(c, **head_kw),
        coder=c.CoderConfig(max_num=12),
        loss=c.LossConfig(max_gt=8),
        img_size=(64, 128),
        img_mean=(103.530, 116.280, 123.675),
        img_std=(57.375, 57.120, 58.395),
        img_bgr=True,
        train=c.TrainConfig(photometric=False, use_grid_mask=False),
        bf16=False,
    )


def extras(cfg, B=1):
    """The JAX step's batch extras of a temporal PETR head."""
    temporal = cfg.head_type == "petrv2" or (
        cfg.head_type == "petr_seg"
        and cfg.head.num_cams > cfg.head.num_frame_cams)
    return {"mean_time_stamp": MTS[:B]} if temporal else {}


def jax_model(jcfg, batch, seed=1):
    model = JaxGraphDETR4D(jcfg)
    args = (jax.random.PRNGKey(0), jnp.asarray(batch["images"]),
            jnp.asarray(batch["lidar2img"]))
    v = jax.jit(model.init).lower(*args).compile(O0)(*args)
    return model, perturb_variables(v, seed=seed)


def port_model(tcfg, v):
    port = GraphDETR4D(tcfg, device="cpu")
    port.load_state_dict(weights.state_dict_from_jax(v), strict=True)
    return port.eval()


def tree_items(tree, path=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from tree_items(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def assert_round_trip(v, cfg):
    """state_dict_from_jax, read back by the JAX converter, gives the flax
    variables exactly."""
    sd = {k: t.numpy() for k, t in weights.state_dict_from_jax(v).items()}
    back = convert_state_dict(sd, num_decoder_layers=cfg.head.num_decoder_layers,
                              nheads=cfg.head.num_heads)
    want = dict(tree_items({"params": v["params"],
                            "batch_stats": v["batch_stats"]}))
    got = dict(tree_items(back))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    return sd


# ------------------------------------------------------------- modules
def test_pos2posemb3d_matches_jax():
    pos = np.random.RandomState(0).rand(3, 7, 3).astype(np.float32)
    want = jax_petr.pos2posemb3d(jnp.asarray(pos), 16)
    got = petr_head.pos2posemb3d(torch.from_numpy(pos), 16)
    assert got.shape == (3, 7, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_reg_layer_matches_jax():
    x = np.random.RandomState(1).randn(2, 5, 32).astype(np.float32)
    mod = jax_petr.RegLayer(32)
    v = perturb_variables(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = mod.apply(jax_vars(v), jnp.asarray(x))
    w = weights._Writer(v["params"])
    weights._reg_layer(w, [], "r")
    port = petr_head.RegLayer(32)
    port.load_state_dict(weights.to_torch(
        {k[2:]: a for k, a in w.sd.items()}), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, 5, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_petr_decoder_layer_matches_jax(masked):
    rng = np.random.RandomState(2)
    B, Q, K, C = 2, 6, 40, 32
    q, qp = (rng.randn(B, Q, C).astype(np.float32) for _ in range(2))
    mem, kp = (rng.randn(B, K, C).astype(np.float32) for _ in range(2))
    valid = rng.rand(B, K) > 0.3 if masked else None
    mod = jax_petr.PETRDecoderLayer(embed_dims=C, num_heads=4, ffn_dims=64)
    args = [jnp.asarray(a) for a in (q, qp, mem, kp)]
    jv = None if valid is None else jnp.asarray(valid)
    v = perturb_variables(mod.init(jax.random.PRNGKey(0), *args, True, jv))
    want = mod.apply(jax_vars(v), *args, True, jv)
    port = petr_head.PETRDecoderLayer(C, 4, 64)
    port.load_state_dict(weights.to_torch(
        weights.petr_decoder_layer_state_dict(v["params"])), strict=True)
    key_mask = (None if valid is None
                else torch.from_numpy(valid)[:, None, None, :])
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (q, qp, mem, kp)),
                   key_mask=key_mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


# ---------------------------------------------------------------- heads
HEAD_CASES = {  # v2, lid, mean_time_stamp, img_valid_hw
    "v1": (False, True, False, False),
    "v1_linear_depth": (False, False, False, False),
    "v1_padding_mask": (False, True, False, True),
    "v2": (True, True, True, False),
    "v2_without_mean_time_stamp": (True, True, False, False),
    "v2_padding_mask_linear_depth": (True, False, True, True),
}


@pytest.mark.parametrize("case", list(HEAD_CASES))
def test_petr_head_matches_jax(case):
    v2, lid, with_mts, padded = HEAD_CASES[case]
    rng = np.random.RandomState(3)
    B, N, H, W, CIN = 2, 4, 4, 5, 24
    feat = rng.randn(B, N, H, W, CIN).astype(np.float32)
    l2i = (rng.randn(B, N, 4, 4) + 3 * np.eye(4)).astype(np.float32)
    valid_hw = (np.stack([rng.randint(30, 65, (B, N)),
                          rng.randint(40, 81, (B, N))], -1).astype(np.float32)
                if padded else None)
    mts = MTS if with_mts else None
    jcfg = head_config(jax_config, petr_lid=lid)
    mod = jax_petr.PETRHead(
        cfg=jcfg, img_shape=IMG, position_range=jcfg.petr_position_range,
        lid=lid, with_time=v2, with_fpe=v2, with_multi=v2,
        per_layer_branches=v2)

    def j(a):
        return None if a is None else jnp.asarray(a)

    jargs = ([jnp.asarray(feat)], jnp.asarray(l2i))
    kw = dict(mean_time_stamp=j(mts), img_valid_hw=j(valid_hw))
    v = perturb_variables(mod.init(jax.random.PRNGKey(0), *jargs, **kw))
    want = mod.apply(jax_vars(v), *jargs, **kw)

    port = petr_head.PETRHead(
        head_config(port_config, petr_lid=lid), IMG, CIN, with_time=v2,
        with_fpe=v2, with_multi=v2, per_layer_branches=v2)
    port.load_state_dict(weights.to_torch(
        weights.petr_head_state_dict(v["params"])), strict=True)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    with torch.no_grad():
        got = port([t(feat)], t(l2i), mean_time_stamp=t(mts),
                   img_valid_hw=t(valid_hw))
    if padded:  # some pixels are padding, none of the cameras is all padding
        _, key_mask = port.padding_mask(B, N, H, W, t(valid_hw), "cpu")
        assert 0 < int(key_mask.sum()) < key_mask.numel()
    assert float(got["cam_overflow"]) == 0.0
    for k in ("all_cls_scores", "all_bbox_preds"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=HEAD_ATOL, err_msg=k)


# ----------------------------------------------------------- detectors
@pytest.mark.parametrize("head_type,neck", [
    ("petr", "cpfpn"), ("petr", "cpfpn_extra"), ("petr", "c5"),
    ("petrv2", "fpn")])
def test_petr_detector_matches_jax(head_type, neck):
    """CPFPN (level-0 conv only; with an extra level, JAX's fpn_conv2 is
    the port's fpn_convs.1), the neck-less C5 detector whose input_proj
    reads the raw 512-channel C5, and PETRv2 over a standard FPN."""
    jcfg = petr_config(jax_config, head_type, neck)
    tcfg = petr_config(port_config, head_type, neck)
    batch = synthetic_batch(jcfg, batch_size=1, seed=0)
    model, v = jax_model(jcfg, batch)
    ex = extras(jcfg)
    want = jax.jit(model.apply)(
        jax_vars(v), jnp.asarray(batch["images"]),
        jnp.asarray(batch["lidar2img"]),
        **{k: jnp.asarray(a) for k, a in ex.items()})
    port = port_model(tcfg, v)
    if neck == "c5":
        assert port.img_neck is None and "neck" not in v["params"]
        assert port.pts_bbox_head.input_proj.weight.shape[1] == 512
    elif neck.startswith("cpfpn"):
        assert len(port.img_neck.fpn_convs) == jcfg.neck.num_outs - 1
    with torch.no_grad():
        got = port(torch.from_numpy(batch["images"]),
                   torch.from_numpy(batch["lidar2img"]),
                   **{k: torch.from_numpy(a) for k, a in ex.items()})
    for k in ("all_cls_scores", "all_bbox_preds"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=HEAD_ATOL, err_msg=k)


# -------------------------------------------------------------- weights
@pytest.mark.parametrize("head_type", ["petr", "petrv2"])
def test_state_dict_round_trips_through_the_jax_converter(head_type):
    jcfg = petr_config(jax_config, head_type)
    _, v = jax_model(jcfg, synthetic_batch(jcfg, batch_size=1, seed=0))
    sd = assert_round_trip(v, jcfg)
    port = GraphDETR4D(petr_config(port_config, head_type), device="cpu")
    assert set(port.state_dict()) == set(sd)
    hd = "pts_bbox_head"
    if head_type == "petr":  # one shared branch, written at every index
        for key in ("cls_branches.{}.0.weight", "reg_branches.{}.4.weight"):
            np.testing.assert_array_equal(sd[f"{hd}.{key.format(0)}"],
                                          sd[f"{hd}.{key.format(1)}"])
        assert port.pts_bbox_head.cls_branches[0] is \
            port.pts_bbox_head.cls_branches[1]
    else:
        assert f"{hd}.reg_branches.1.task_heads.4.2.weight" in sd
        assert f"{hd}.reg_branches.0.reg_branch.3.weight" in sd
        assert f"{hd}.fpe.conv_reduce.weight" in sd


def test_shared_branches_load_the_last_index_and_step_once():
    """A v1 dict whose branch indices differ (not a checkpoint the
    reference writes) loads with the last index winning; AdamW sees each
    shared tensor once, with the gradient of every layer."""
    cfg = petr_config(port_config, "petr")
    port = GraphDETR4D(cfg, device="cpu")
    weights.init_weights(port, seed=0)
    sd = port.state_dict()
    sd["pts_bbox_head.cls_branches.1.0.weight"] = \
        sd["pts_bbox_head.cls_branches.1.0.weight"] + 1.0
    last = sd["pts_bbox_head.cls_branches.1.0.weight"].clone()
    port.load_state_dict(sd, strict=True)
    head = port.pts_bbox_head
    torch.testing.assert_close(head.cls_branches[0][0].weight.detach(), last,
                               rtol=0, atol=0)
    names = [n for n, _ in port.named_parameters()]
    assert "pts_bbox_head.cls_branches.0.0.weight" in names
    assert not any(n.startswith("pts_bbox_head.cls_branches.1.") for n in names)
    # reference points drawn uniform in [0, 1)
    ref = head.reference_points.weight.detach()
    assert 0.0 <= float(ref.min()) and float(ref.max()) < 1.0


# ---------------------------------------------------------------- train
def grad_of(p):
    """p's gradient; zeros where the loss does not reach p (the FPN levels
    a PETR head does not read), as jax.grad gives."""
    return p.grad.clone() if p.grad is not None else torch.zeros_like(p)


def port_sensitivity(step, batch, rel=1e-6):
    """The most the port's raw gradient of each parameter moves, through
    the step's own loss, when the images change by `rel` relative: scaled
    by 1 + rel, and moved by rel * |x| along a seeded random direction.
    The second probe flips the ReLUs within ~1e-7 of 0 that a uniform
    scale leaves on their side, as the JAX-port forward difference (about
    1e-6 relative at these widths) does."""
    images = batch["images"]
    noise = torch.randn(images.shape, generator=torch.Generator().manual_seed(0))
    probes = (images, images * (1.0 + rel), images + rel * images.abs() * noise)
    grads = []
    for x in probes:
        step.model.zero_grad(set_to_none=True)
        total, _ = step.loss(dict(batch, images=x))
        total.backward()
        grads.append({n: grad_of(p) for n, p in step.model.named_parameters()})
    step.model.zero_grad(set_to_none=True)
    return {n: np.maximum(*((g[n] - grads[0][n]).abs().numpy()
                            for g in grads[1:])) for n in grads[0]}


def jax_step_and_grads(jcfg, model, v, jbatch):
    """(metrics of one build_train_step step, gradient tree of its loss)."""
    tx = build_optimizer(jcfg.train)
    fresh = jax_vars(v)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=fresh["params"],
                       batch_stats=fresh["batch_stats"],
                       opt_state=tx.init(fresh["params"]))
    rng = jax.random.PRNGKey(3)
    exe = build_train_step(model, jcfg, mesh=None).lower(
        state, jbatch, rng).compile(O0)
    _, metrics = exe(state, jbatch, rng)

    def loss_fn(params):  # the step's loss, outside the optimizer
        from graph_detr4d_tpu.core.losses import detr3d_loss
        from graph_detr4d_tpu.models.petr_seg import lane_mask_loss

        out = model.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jbatch["images"], jbatch["lidar2img"], train=True,
            rng=jax.random.PRNGKey(1),
            mean_time_stamp=jbatch.get("mean_time_stamp"),
            rngs={"dropout": jax.random.PRNGKey(2)})
        total, _ = detr3d_loss(out, jbatch["gt_bboxes"], jbatch["gt_labels"],
                               jbatch["gt_valid"], jcfg.loss, jcfg.head)
        if "maps" in jbatch:
            for p in out["all_lane_preds"]:
                total = total + jax.vmap(lane_mask_loss)(
                    p, jbatch["maps"]).mean()
        return total

    params = jax_vars(v)["params"]  # the step donated `fresh`
    grads = jax.jit(jax.grad(loss_fn)).lower(params).compile(O0)(params)
    return metrics, grads


def assert_step_matches_jax(jcfg, tcfg, batch):
    """One port TrainStep step against the JAX step's metrics, and the
    port's gradients against jax.grad of the same loss."""
    model, v = jax_model(jcfg, batch, seed=7)
    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}
    want, grads = jax_step_and_grads(jcfg, model, v, jbatch)

    port = GraphDETR4D(tcfg, device="cpu")
    port.load_state_dict(weights.state_dict_from_jax(v), strict=True)
    step = TrainStep(port, tcfg)
    tbatch = {k: torch.from_numpy(np.asarray(a)) for k, a in batch.items()}
    sensitivity = port_sensitivity(step, tbatch)
    step.model.zero_grad(set_to_none=True)
    total, _ = step.loss(tbatch)
    total.backward()
    want_g = weights.state_dict_from_jax(
        {"params": grads, "batch_stats": v["batch_stats"]})
    for name, p in step.model.named_parameters():
        w = want_g[name].numpy()
        tol = (RTOL * max(float(np.abs(w).max()), 1e-12)
               + 2 * float(sensitivity[name].max()))
        np.testing.assert_allclose(grad_of(p).numpy(), w, rtol=0, atol=tol,
                                   err_msg=name)
    got = step.step(tbatch)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   err_msg=k)
    return got


def test_petrv2_train_step_matches_jax():
    """PETRv2 over R50-DCN and the standard FPN (petrv2_res50_*'s
    structure), with mean_time_stamp."""
    jcfg = petr_config(jax_config, "petrv2", "fpn", depth=50)
    tcfg = petr_config(port_config, "petrv2", "fpn", depth=50)
    batch = dict(synthetic_batch(jcfg, batch_size=1, seed=0, num_gt=5),
                 **extras(jcfg))
    got = assert_step_matches_jax(jcfg, tcfg, batch)
    assert "mean_time_stamp" in batch and float(got["loss"]) > 0
