"""The port's host tools (graph_detr4d_tpu_torch/tools/{fuse_conv_bn,
print_config,visualize_results,browse_dataset,publish_model}.py) against
the JAX package's tools/misc/ and tools/model_converters/ on the CPU:

  * fuse_conv_bn: on ResNet-18, ResNet-50, R50-DCN, VoVNet-99 and
    MobileNetV2 the port folds the BNs the JAX tool's fuse_tree folds on
    the same weights (its trees from jax.eval_shape, filled with seeded
    numpy values, mapped to the port's names by weights.py): 20 / 53 / 44
    / 0 / 50 pairs, and on ResNet-18 the folded tensors equal the JAX
    tool's within 1e-6; a folded ResNet-18's outputs stay within 2e-4 of
    the unfolded one's (tests/test_tools.py:22-56); the CLI folds a tiny
    checkpoint, keeping its step and optimizer state, and the whole tiny
    model's outputs stay within 2e-4;
  * print_config: stdout byte-equal for --list, all 35 configs and one
    --cfg-options override;
  * visualize_results / browse_dataset: byte-equal PNG files, on random
    boxes, on a results file of the port's test CLI, and on the
    data/fixture.py dataset;
  * publish_model: the published file loads with strict=True and holds
    the source weights; its hash is the same on two runs and changes with
    the weights.
"""

import contextlib
import filecmp
import importlib.util
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from graph_detr4d_tpu import configs as jax_configs  # noqa: E402
from graph_detr4d_tpu.models import mobilenet as jax_mobilenet  # noqa: E402
from graph_detr4d_tpu.models import resnet as jax_resnet  # noqa: E402
from graph_detr4d_tpu.models import vovnet as jax_vovnet  # noqa: E402
from graph_detr4d_tpu_torch import weights  # noqa: E402
from graph_detr4d_tpu_torch.config import tiny_test_config  # noqa: E402
from graph_detr4d_tpu_torch.data.fixture import write_nuscenes_fixture  # noqa: E402
from graph_detr4d_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from graph_detr4d_tpu_torch.models import mobilenet, resnet, vovnet  # noqa: E402
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D  # noqa: E402
from graph_detr4d_tpu_torch.tools import (browse_dataset, fuse_conv_bn,  # noqa: E402
                                          print_config, publish_model,
                                          visualize_results)
from graph_detr4d_tpu_torch.tools import test as test_cli  # noqa: E402
from graph_detr4d_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from graph_detr4d_tpu_torch.weights import init_weights  # noqa: E402

FOLD_ATOL = 2e-4  # tests/test_tools.py:54
TINY12 = ["--tiny", "--cfg-options", "head.num_cams=12", "head.num_frame_cams=6"]


def _load(relpath, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_fuse = _load("tools/misc/fuse_conv_bn.py", "jax_fuse_conv_bn")
jax_print_config = _load("tools/misc/print_config.py", "jax_print_config")
jax_viz = _load("tools/misc/visualize_results.py", "jax_visualize_results")
jax_browse = _load("tools/misc/browse_dataset.py", "jax_browse_dataset")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def run_main(main, argv):
    """stdout of a JAX tool's main() run with sys.argv = argv."""
    out, saved = io.StringIO(), sys.argv
    sys.argv = ["tool"] + argv
    try:
        with contextlib.redirect_stdout(out):
            main()
    finally:
        sys.argv = saved
    return out.getvalue()


# ------------------------------------------------------------ fuse_conv_bn
BACKBONES = {
    "resnet18": (lambda: jax_resnet.ResNet(depth=18, use_dcn=False),
                 lambda: resnet.ResNet(depth=18, use_dcn=False), 20),
    "resnet50": (lambda: jax_resnet.ResNet(depth=50, use_dcn=False),
                 lambda: resnet.ResNet(depth=50, use_dcn=False), 53),
    "r50_dcn": (lambda: jax_resnet.ResNet(depth=50),
                lambda: resnet.ResNet(depth=50), 44),
    "vovnet99": (lambda: jax_vovnet.VoVNet(), lambda: vovnet.VoVNet(), 0),
    "mobilenetv2": (lambda: jax_mobilenet.MobileNetV2(out_indices=(2, 4, 7)),
                    lambda: mobilenet.MobileNetV2((2, 4, 7)), 50),
}


def jax_trees(model, seed=0):
    """The flax backbone's params and batch_stats from jax.eval_shape (no
    compile), filled with seeded numpy values: weights normal / 8, BN
    statistics uniform(0.5, 1.5) so that a folded BN (mean 0) shows."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) / 8).astype(np.float32),
        shapes["params"])
    stats = jax.tree.map(
        lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32),
        shapes["batch_stats"])
    return params, stats


def folded_bns(sd):
    """The BN names of a reference-layout dict whose statistics a fold
    left: mean 0 and var 1 - eps."""
    return {k[: -len(".running_mean")] for k, v in sd.items()
            if k.endswith(".running_mean") and not np.any(np.asarray(v))
            and np.all(np.asarray(sd[k.replace("mean", "var")], np.float32)
                       == np.float32(1.0 - jax_fuse.EPS))}


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_fold_takes_the_jax_tools_pairs(name):
    jax_model, port_model, count = BACKBONES[name]
    params, stats = jax_trees(jax_model())
    want = jax_fuse.fuse_tree(params, stats)
    folded = weights.any_backbone_state_dict(params, stats)
    pairs = fuse_conv_bn.conv_bn_pairs(port_model())
    assert want == count and len(pairs) == count
    assert {bn for _, bn in pairs} == folded_bns(folded)


def test_fold_arithmetic_matches_the_jax_tool():
    """ResNet-18's folded conv weights and BN tensors equal the JAX
    tool's on the same weights."""
    params, stats = jax_trees(jax_resnet.ResNet(depth=18, use_dcn=False), 1)
    unfolded = weights.to_torch(weights.backbone_state_dict(params, stats))
    jax_fuse.fuse_tree(params, stats)
    want = weights.to_torch(weights.backbone_state_dict(params, stats))
    got = {f"img_backbone.{k}": v.clone() for k, v in unfolded.items()}
    n = fuse_conv_bn.fuse_state_dict(got, resnet.ResNet(depth=18, use_dcn=False))
    assert n == 20
    for k, v in want.items():
        np.testing.assert_allclose(got[f"img_backbone.{k}"].numpy(), v.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_folded_resnet18_keeps_its_outputs():
    """tests/test_tools.py:22-56 on the port: random BN statistics,
    uniform(0.5, 1.5), folded; every stage within 2e-4."""
    torch.manual_seed(0)
    net = resnet.ResNet(depth=18, use_dcn=False)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, buf in net.named_buffers():
            buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
    x = torch.randn(1, 3, 64, 64, generator=gen)
    with torch.no_grad():
        want = net(x)
        sd = {f"img_backbone.{k}": v.clone() for k, v in net.state_dict().items()}
        assert fuse_conv_bn.fuse_state_dict(sd, net) == 20
        net.load_state_dict({k[len("img_backbone."):]: v for k, v in sd.items()})
        got = net(x)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=FOLD_ATOL)


def test_fuse_cli_folds_a_checkpoint(tmp_path, capsys):
    cfg = tiny_test_config()
    model = GraphDETR4D(cfg, device="cpu")
    init_weights(model, 0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, buf in model.img_backbone.named_buffers():
            buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    opt = {"state": {}, "param_groups": [{"lr": 2e-4}]}
    CheckpointManager(src, cfg).save(7, {"state_dict": model.state_dict(),
                                         "optimizer": opt}, {"loss": 1.5})
    n = fuse_conv_bn.main(["--in-dir", src, "--out-dir", dst, "--tiny",
                           "--device", "cpu"])
    assert n == 20
    assert capsys.readouterr().out.strip().endswith(
        f"fused 20 conv+bn pairs -> {dst}")
    out = CheckpointManager(dst).restore()
    assert out["step"] == 7 and out["optimizer"] == opt
    assert out["meta"]["metrics"] == {"loss": 1.5}
    fused = GraphDETR4D(cfg, device="cpu")
    fused.load_state_dict(out["state_dict"], strict=True)
    batch = synthetic_batch(cfg, 1)
    images = torch.as_tensor(batch["images"])
    l2i = torch.as_tensor(batch["lidar2img"])
    with torch.no_grad():
        want = model.eval()(images, l2i)
        got = fused.eval()(images, l2i)
    for k in ("all_cls_scores", "all_bbox_preds"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=FOLD_ATOL, err_msg=k)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fuse_conv_bn.main(["--in-dir", src, "--out-dir", dst, "--tiny"])


# ------------------------------------------------------------ print_config
def config_argvs():
    names = jax_configs.list_configs()
    assert len(names) == 35
    return ([["--list"], []] + [["--config", n] for n in names]
            + [["--config", "detr3d_res50", "--cfg-options",
                "head.num_query=60"]])


def test_print_config_is_byte_equal(capsys):
    """Byte for byte the JAX tool's output, once the port's own entries'
    lines (PORT_ONLY, listed among the model configs) are taken out."""
    from graph_detr4d_tpu_torch.configs import PORT_ONLY

    own = {f"  {n}\n" for n in PORT_ONLY}
    argvs = config_argvs()
    for argv in argvs:
        want = run_main(jax_print_config.main, argv)
        print_config.main(argv)
        got = capsys.readouterr().out
        lines = got.splitlines(keepends=True)
        if argv in (["--list"], []):
            assert own <= set(lines), argv
        assert "".join(x for x in lines if x not in own) == want, argv
    assert '"num_query": 60' in got


# ------------------------------------------------- visualize / browse
def random_boxes(rng, n):
    boxes = rng.uniform(-60, 60, (n, 9)).astype(np.float32)
    boxes[:, 3:6] = rng.uniform(0.5, 6, (n, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return boxes, rng.randint(0, 10, n), rng.uniform(0, 1.2, n).astype(np.float32)


@pytest.mark.parametrize("size", [128, 640])
def test_bev_png_is_byte_equal(tmp_path, size):
    boxes, labels, scores = random_boxes(np.random.RandomState(size), 40)
    pcr = [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0]
    want = jax_viz.draw_bev(boxes, labels, scores, pcr, size=size)
    got = visualize_results.draw_bev(boxes, labels, scores, pcr, size=size)
    assert got.dtype == np.uint8 and got.max() > 0
    np.testing.assert_array_equal(got, want)
    jax_viz.save_png(str(tmp_path / "want.png"), want)
    visualize_results.save_png(str(tmp_path / "got.png"), got)
    assert filecmp.cmp(tmp_path / "want.png", tmp_path / "got.png", shallow=False)


@pytest.fixture(scope="module")
def fixture_ann(tmp_path_factory):
    ann, _ = write_nuscenes_fixture(str(tmp_path_factory.mktemp("nusc")), 2,
                                    src_hw=(90, 160))
    return ann


def same_pngs(dir_a, dir_b, count):
    names = sorted(os.listdir(dir_a))
    assert names == sorted(os.listdir(dir_b)) and len(names) == count
    for n in names:
        assert filecmp.cmp(os.path.join(dir_a, n), os.path.join(dir_b, n),
                           shallow=False), n


def test_visualize_results_on_test_cli_results(tmp_path, fixture_ann, capsys):
    """The test CLI writes `boxes` / `scores` / `labels`, and both tools
    read mmdet3d's `boxes_3d` / `scores_3d` / `labels_3d` (ROADMAP Queue
    3): the results are renamed here."""
    out = str(tmp_path / "out.json")
    test_cli.main(TINY12 + ["--device", "cpu", "--ann-file", fixture_ann,
                            "--max-samples", "2", "--out", out])
    with open(out) as f:
        results = json.load(f)["results"]
    assert len(results) == 2
    res = str(tmp_path / "res.json")
    with open(res, "w") as f:
        json.dump({"results": [{f"{k}_3d": r[k] for k in
                                ("boxes", "scores", "labels")}
                               for r in results]}, f)
    run_main(jax_viz.main, ["--results", res, "--out-dir", str(tmp_path / "a")])
    capsys.readouterr()
    visualize_results.main(["--results", res, "--out-dir", str(tmp_path / "b")])
    assert capsys.readouterr().out.split() == [
        str(tmp_path / "b" / f"sample{i:04d}_bev.png") for i in range(2)]
    same_pngs(tmp_path / "a", tmp_path / "b", 2)


def test_browse_dataset_is_byte_equal(tmp_path, fixture_ann, capsys):
    want = run_main(jax_browse.main, ["--ann-file", fixture_ann, "--out-dir",
                                      str(tmp_path / "a")])
    browse_dataset.main(["--ann-file", fixture_ann, "--out-dir",
                         str(tmp_path / "b")])
    got = capsys.readouterr().out
    assert got == want.replace(str(tmp_path / "a"), str(tmp_path / "b"))
    assert "centers in view" in got
    same_pngs(tmp_path / "a", tmp_path / "b", 24)


# ------------------------------------------------------------ publish_model
def test_publish_round_trip_and_stable_hash(tmp_path, capsys):
    cfg = tiny_test_config()
    model = GraphDETR4D(cfg, device="cpu")
    init_weights(model, 0)
    src = str(tmp_path / "ckpt")
    CheckpointManager(src, cfg).save(3, {"state_dict": model.state_dict(),
                                         "optimizer": {"state": {}}})
    argv = ["--in-dir", src, "--tiny", "--device", "cpu"]
    out1 = publish_model.main(argv + ["--out-dir", str(tmp_path / "r1")])
    out2 = publish_model.main(argv + ["--out-dir", str(tmp_path / "r2")])
    digest = os.path.basename(out1)[len("published-"):]
    assert len(digest) == 8 and int(digest, 16) >= 0
    assert os.path.basename(out2) == os.path.basename(out1)
    assert f"(sha {digest})" in capsys.readouterr().out
    pub = CheckpointManager(out1).restore()
    assert set(pub) == {"state_dict", "meta"} and pub["meta"]["step"] == 0
    back = GraphDETR4D(cfg, device="cpu")
    back.load_state_dict(pub["state_dict"], strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    assert publish_model.state_dict_hash(pub["state_dict"]) == digest
    changed = dict(model.state_dict())
    changed["img_backbone.conv1.weight"] = changed["img_backbone.conv1.weight"] + 1
    assert publish_model.state_dict_hash(changed) != digest
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        publish_model.main(argv[:-2] + ["--out-dir", str(tmp_path / "r3")])
