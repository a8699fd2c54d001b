"""The port's weight bridge, configs and package boundaries.

* weights.state_dict_from_jax equals tools/convert_checkpoint's
  export_state_dict key for key and value for value, and every key loads
  into the port's GraphDETR4D with strict=True;
* the port's config dataclasses and named configs equal the JAX ones
  field for field;
* no module of graph_detr4d_tpu_torch (nor chip_smoke.py) imports jax,
  flax or graph_detr4d_tpu;
* importing the package builds nothing and needs no nvcc or triton;
* entry points raise without CUDA unless device="cpu" is passed.

Weights here are seeded random numbers shaped by `jax.eval_shape` of the
JAX model's init, which traces without compiling.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from tests.test_torch_slice import slice_config  # noqa: E402
from tools.convert_checkpoint import export_state_dict  # noqa: E402

import graph_detr4d_tpu.config as jax_config  # noqa: E402
import graph_detr4d_tpu.configs as jax_configs  # noqa: E402
from graph_detr4d_tpu.models import GraphDETR4D as JaxGraphDETR4D  # noqa: E402
import graph_detr4d_tpu_torch.config as port_config  # noqa: E402
import graph_detr4d_tpu_torch.configs as port_configs  # noqa: E402
from graph_detr4d_tpu_torch.models.detector import (  # noqa: E402
    GraphDETR4D, check_supported)
from graph_detr4d_tpu_torch.serve import Engine  # noqa: E402
from graph_detr4d_tpu_torch.weights import state_dict_from_jax  # noqa: E402

PACKAGE = REPO / "graph_detr4d_tpu_torch"
FLAGSHIP = "detr4d_res50_deform_pe_testaug_2subset_12e"


def _random_variables(cfg, seed=0):
    """flax variables of GraphDETR4D(cfg), filled with seeded noise."""
    N, (H, W) = cfg.head.num_cams, cfg.img_size
    shapes = jax.eval_shape(
        JaxGraphDETR4D(cfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, N, H, W, 3)), jnp.zeros((1, N, 4, 4)))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("name", [
    "slice", FLAGSHIP, "h_detr4d_res50_deform_pe_testaug_2subset_12e",
    "detr4d_res18_deform_pe_testaug_320_2subset"])
def test_state_dict_from_jax_equals_export_and_loads_strict(name):
    if name == "slice":
        jcfg, tcfg = slice_config(jax_config), slice_config(port_config)
    else:
        jcfg, tcfg = jax_configs.get_config(name), port_configs.get_config(name)
    variables = _random_variables(jcfg)
    want = export_state_dict(variables,
                             num_decoder_layers=jcfg.head.num_decoder_layers,
                             nheads=jcfg.head.num_heads)
    got = state_dict_from_jax(variables)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)

    model = GraphDETR4D(tcfg, device="cpu")
    result = model.load_state_dict(got, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    sd = model.state_dict()
    assert set(sd) == set(got)
    for k in ("img_backbone.layer3.0.conv2.weight",
              "pts_bbox_head.transformer.decoder.layers.1.attentions.0.attn"
              ".in_proj_weight"):
        torch.testing.assert_close(sd[k], got[k])


def test_obj_dgcnn_bridge_loads_strict_at_full_width():
    """The LiDAR bridge at the JAX ObjDGCNN's defaults (128 x 128 grid, 64
    pillar channels, 900 queries, width 256, 6 layers): every key loads
    strict, and the auto-named flax modules land where their creation
    order puts them."""
    from graph_detr4d_tpu.models.dgcnn import ObjDGCNN as JaxObjDGCNN
    from graph_detr4d_tpu_torch.models.dgcnn import ObjDGCNN
    from graph_detr4d_tpu_torch.weights import obj_dgcnn_state_dict_from_jax

    shapes = jax.eval_shape(
        JaxObjDGCNN(head_cfg=jax_config.HeadConfig()).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 5)), jnp.zeros((1, 64)))
    rng = np.random.RandomState(0)
    v = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    sd = obj_dgcnn_state_dict_from_jax(v)
    model = ObjDGCNN(device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    p, st = v["params"], v["batch_stats"]
    for key, want in (
        ("pts_bbox_head.layer5_ffn.2.weight",
         p["pts_bbox_head"]["Dense_11"]["kernel"].T),
        ("pts_bbox_head.layer2_self_attn.conv2_bn.running_var",
         st["pts_bbox_head"]["layer2_self_attn"]["conv2_bn"]["var"]),
        ("pts_backbone.stage2_norm4.weight",
         p["pts_backbone"]["LayerNorm_15"]["scale"]),
        ("pts_backbone.stage1_down_norm.bias",
         p["pts_backbone"]["LayerNorm_4"]["bias"]),
        ("pts_neck.fpn_convs.0.weight",
         np.transpose(p["pts_neck"]["Conv_3"]["kernel"], (3, 2, 0, 1))),
        ("pts_neck.extra_convs.0.bias", p["pts_neck"]["Conv_6"]["bias"]),
        ("pillar_encoder.pfn.weight", p["pillar_encoder"]["pfn"]["kernel"].T),
    ):
        np.testing.assert_array_equal(model.state_dict()[key].numpy(), want,
                                      err_msg=key)


def test_init_weights_covers_the_lidar_modules():
    """Seeded, and the zero-initialised projections of the LiDAR head get
    noise: sampling offsets and attention weights vary, the offset bias
    is the circular grid, the reg outputs are scaled down."""
    from graph_detr4d_tpu.models.dgcnn import _grid_offset_bias
    from graph_detr4d_tpu_torch.config import HeadConfig
    from graph_detr4d_tpu_torch.models.dgcnn import ObjDGCNN
    from graph_detr4d_tpu_torch.weights import REG_OUT_SCALE, init_weights

    cfg = HeadConfig(num_query=16, embed_dims=32, num_decoder_layers=2,
                     num_heads=4, num_points=2, ffn_dims=64)
    a, b = (ObjDGCNN(cfg, (16, 16), 8, 4, device="cpu") for _ in range(2))
    init_weights(a, seed=3)
    init_weights(b, seed=3)
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(x, y, msg=k)
    attn = a.pts_bbox_head.layer1_cross_attn
    assert attn.sampling_offsets.weight.abs().min() > 0
    assert attn.attention_weights.weight.std() > 0.05
    np.testing.assert_allclose(attn.sampling_offsets.bias.detach().numpy(),
                               _grid_offset_bias(4, 4, 2), atol=1e-6)
    bn = a.pts_bbox_head.layer0_self_attn.conv1_bn
    assert not torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    out = a.pts_bbox_head.reg_branch1[-1].weight
    assert out.std() < 2 * REG_OUT_SCALE / np.sqrt(out.shape[1])


def test_mmcv_checkpoint_with_bn_counters_loads_strict():
    """A published mmdet3d checkpoint also carries BatchNorm's
    num_batches_tracked; the frozen BN drops it on load."""
    tcfg = slice_config(port_config)
    model = GraphDETR4D(tcfg, device="cpu")
    sd = dict(model.state_dict())
    for k in list(sd):
        if k.endswith(".running_var"):
            sd[k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    model.load_state_dict(sd, strict=True)


def _fields(cls):
    """(name, type name, default) of each field; nested config classes
    compare by name and value, since each package has its own."""
    out = []
    for f in dataclasses.fields(cls):
        default = (f.default if f.default is not dataclasses.MISSING
                   else f.default_factory())
        if dataclasses.is_dataclass(default):
            default = dataclasses.asdict(default)
        out.append((f.name, getattr(f.type, "__name__", str(f.type)), default))
    return out


def test_config_dataclasses_equal_jax_field_for_field():
    for name in ("BackboneConfig", "NeckConfig", "HeadConfig", "CoderConfig",
                 "LossConfig", "TrainConfig", "ModelConfig"):
        assert _fields(getattr(port_config, name)) == \
            _fields(getattr(jax_config, name)), name
    assert dataclasses.asdict(port_config.tiny_test_config()) == \
        dataclasses.asdict(jax_config.tiny_test_config())
    assert port_config.NUSCENES_CLASSES == jax_config.NUSCENES_CLASSES


@pytest.mark.parametrize("name", jax_configs.list_configs())
def test_named_configs_equal_jax(name):
    ovs = ["head.num_query=600", "bf16=false", "backbone.cam_chunk=none",
           "img_size=(320,800)"]
    for o in ([], ovs):
        assert dataclasses.asdict(port_configs.get_config(name, o)) == \
            dataclasses.asdict(jax_configs.get_config(name, o))
    # the port registers every model of the JAX registry (35 since the
    # PETR family), and builds each; besides them, only its own entries
    # (PORT_ONLY: BEVFormer), which the JAX package does not have
    assert port_configs.list_configs() == sorted(
        jax_configs.list_configs() + list(port_configs.PORT_ONLY))
    check_supported(port_configs.get_config(name))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "orbax",
                                "graph_detr4d_tpu"), (path, mod)


def test_import_builds_nothing_and_needs_no_nvcc_or_triton(tmp_path):
    build_dir = PACKAGE / "_build"
    before = sorted(build_dir.iterdir()) if build_dir.exists() else None
    code = (
        "import sys\n"
        "import graph_detr4d_tpu_torch, graph_detr4d_tpu_torch.serve\n"
        "import graph_detr4d_tpu_torch.weights, chip_smoke\n"
        "from graph_detr4d_tpu_torch.ops import build, msda, deform_conv\n"
        "from graph_detr4d_tpu_torch.ops import voxelize\n"
        "from graph_detr4d_tpu_torch.core import iou3d\n"
        "import graph_detr4d_tpu_torch.models.dgcnn\n"
        "bad = [m for m in ('triton', 'jax', 'flax') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "assert msda.launches == 0 and deform_conv.forward_launches == 0\n"
        "assert deform_conv.backward_launches == 0\n"
    )
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = str(tmp_path)  # no nvcc reachable
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    after = sorted(build_dir.iterdir()) if build_dir.exists() else None
    assert after == before


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is available")
    cfg = slice_config(port_config)
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphDETR4D(cfg)
    model = GraphDETR4D(cfg, device="cpu")
    sd = model.state_dict()
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, sd)
    engine = Engine(cfg, sd, device="cpu")
    assert next(engine.model.parameters()).device.type == "cpu"
    from graph_detr4d_tpu_torch.train.trainer import Trainer

    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, sd, iter([]), "unused-work-dir")
    from graph_detr4d_tpu_torch.core.coder import decode_batch
    from graph_detr4d_tpu_torch.models.dgcnn import ObjDGCNN
    from graph_detr4d_tpu_torch.serve import LidarEngine

    with pytest.raises(RuntimeError, match="CUDA"):
        ObjDGCNN()
    with pytest.raises(RuntimeError, match="CUDA"):
        LidarEngine({})
    # LidarEngine serves the full-width model; its CPU route at a small
    # width is the model and decode it runs
    small = ObjDGCNN(port_config.HeadConfig(
        num_query=16, embed_dims=32, num_decoder_layers=1, num_heads=4,
        num_points=2, ffn_dims=64), (16, 16), 8, 4, device="cpu").eval()
    with torch.inference_mode():
        out = small(torch.zeros(1, 32, 5), torch.ones(1, 32))
    c = port_config.CoderConfig()
    det = decode_batch(out, max_num=c.max_num,
                       post_center_range=c.post_center_range,
                       score_threshold=c.score_threshold)
    assert det.bboxes.shape == (1, 160, 9)
