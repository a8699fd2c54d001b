"""The graph attention variants (MP, DETR3D, DETR3D-v2) and the plain head
(with_pe False) of the port against the JAX package, fp32 on the CPU
(the kernels' plain versions).

Each variant module, and the decoder layer that dispatches it, is held to
the JAX module with the same weights at atol 1e-4 (the per-op tolerance of
tests/test_golden_torch.py); a tiny full GraphDETR4D of each setting at
atol 2e-4 on raw head outputs (tests/test_golden_full_model.py). Weights
are flax's initialisation with the zero-initialised projections replaced
by seeded noise, carried over by weights.state_dict_from_jax, which is held
equal to tools/convert_checkpoint.py::export_state_dict wherever that maps
the variant. The MP query graph's neighbour sets (torch.topk in the port,
jax.lax.top_k in the JAX decoder) are compared row by row.
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
from tools.convert_checkpoint import export_state_dict  # noqa: E402

from graph_detr4d_tpu import config as jax_config  # noqa: E402
from graph_detr4d_tpu import configs as jax_configs  # noqa: E402
from graph_detr4d_tpu.data.synthetic import synthetic_batch  # noqa: E402
from graph_detr4d_tpu.models import GraphDETR4D as JaxGraphDETR4D  # noqa: E402
from graph_detr4d_tpu.models import attention_variants as jax_variants  # noqa: E402
from graph_detr4d_tpu.models import transformer as jax_transformer  # noqa: E402
from graph_detr4d_tpu_torch import config as port_config  # noqa: E402
from graph_detr4d_tpu_torch import configs as port_configs  # noqa: E402
from graph_detr4d_tpu_torch import weights  # noqa: E402
from graph_detr4d_tpu_torch.models import attention_variants, transformer  # noqa: E402
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D  # noqa: E402

HEAD_ATOL = 2e-4
K = 4  # graph neighbours in the module and layer tests
SETTINGS = {  # HeadConfig fields of each setting of the full-model test
    "deform3d_mp": dict(attn_type="deform3d_mp"),
    "detr3d": dict(attn_type="detr3d"),
    "detr3d_v2": dict(attn_type="detr3d_v2"),
    "plain_head": dict(with_pe=False),
}


def perturb(variables, seed):
    """perturb_variables, and the MP neighbour branch's zero-initialised
    attention projection given noise too."""
    v = perturb_variables(variables, seed)
    rng = np.random.RandomState(seed + 100)

    def walk(node):
        for key, child in node.items():
            if key == "attention_weights_neighbor":
                fan_in = child["kernel"].shape[0]
                child["kernel"] = (rng.randn(*child["kernel"].shape)
                                   / np.sqrt(fan_in)).astype(np.float32)
                child["bias"] = (rng.randn(*child["bias"].shape) * 0.1).astype(
                    np.float32)
            elif isinstance(child, dict):
                walk(child)

    walk(v)
    return v


def jax_neighbours(ref, k):
    """The JAX decoder's query graph (transformer.py:123-132): (B, Q, k)."""
    ref = jnp.asarray(ref)
    d2 = jnp.sum((ref[:, :, None, :] - ref[:, None, :, :]) ** 2, -1)
    d2 = d2 + jnp.eye(ref.shape[1], dtype=d2.dtype) * 1e9
    return np.asarray(jax.lax.top_k(-d2, k)[1])


def flipped_rows(got, want):
    """Rows whose neighbour sets differ."""
    return int((np.sort(got, -1) != np.sort(want, -1)).any(-1).sum())


def _variant_modules(name, jcfg):
    kw = dict(embed_dims=jcfg.embed_dims, num_levels=jcfg.num_levels,
              num_cams=jcfg.num_cams, pc_range=PC_RANGE)
    if name == "detr3d":
        return (jax_variants.Detr3DCrossAtten(num_points=1, dropout=0.0, **kw),
                attention_variants.Detr3DCrossAtten(num_points=1, **kw))
    kw.update(num_heads=jcfg.num_heads, num_points=jcfg.num_points)
    if name == "detr3d_v2":
        return (jax_variants.Detr3DCrossAttenV2(dropout=0.0, **kw),
                attention_variants.Detr3DCrossAttenV2(**kw))
    return (jax_variants.Deform3DCrossAttnMP(num_neighbors=K, dropout=0.0, **kw),
            attention_variants.Deform3DCrossAttnMP(num_neighbors=K, **kw))


@pytest.mark.parametrize("name", ["deform3d_mp", "detr3d", "detr3d_v2"])
def test_variant_cross_attn_matches_jax(name):
    """Each variant module; MP fed the centre points and K neighbour
    points of random other queries, neighbour-major."""
    jcfg, _ = _head_cfg()
    d = _attn_inputs(jcfg, overflow=False, seed=6)
    ref = d["ref"]
    if name == "deform3d_mp":
        B, Q, _ = ref.shape
        idx = np.random.RandomState(7).randint(0, Q, (B, K * Q))
        ref = np.concatenate([ref, ref[np.arange(B)[:, None], idx]], axis=1)
    jmod, tmod = _variant_modules(name, jcfg)
    args = (jnp.asarray(d["query"]), [jnp.asarray(v) for v in d["levels"]],
            jnp.asarray(d["query_pos"]), jnp.asarray(ref),
            jnp.asarray(d["l2i"]), d["img"])
    v = perturb(jmod.init(jax.random.PRNGKey(6), *args), seed=8)
    want = jmod.apply(jax_vars(v), *args)
    port = load(tmod, weights.cross_attn_state_dict(v["params"]))
    with torch.no_grad():
        got, overflow = port(
            torch.from_numpy(d["query"]), _flat_levels(d["levels"]),
            d["shapes"], torch.from_numpy(d["query_pos"]), torch.from_numpy(ref),
            torch.from_numpy(d["l2i"]), d["img"])
    assert float(overflow) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["deform3d_mp", "detr3d", "detr3d_v2"])
def test_variant_decoder_layer_matches_jax(name):
    """The decoder layer's dispatch, with MP's query graph built from the
    reference points (its neighbour sets equal to jax.lax.top_k's)."""
    jcfg, _ = _head_cfg()
    d = _attn_inputs(jcfg, overflow=False, seed=9)
    kw = dict(embed_dims=jcfg.embed_dims, num_heads=jcfg.num_heads,
              num_levels=jcfg.num_levels, num_points=jcfg.num_points,
              num_cams=jcfg.num_cams, ffn_dims=jcfg.ffn_dims, pc_range=PC_RANGE,
              attn_type=name, num_neighbors=K)
    mod = jax_transformer.DecoderLayer(dropout=0.0, **kw)
    args = (jnp.asarray(d["query"]), jnp.asarray(d["query_pos"]),
            [jnp.asarray(v) for v in d["levels"]], jnp.asarray(d["ref"]),
            jnp.asarray(d["l2i"]), d["img"])
    v = perturb(mod.init(jax.random.PRNGKey(9), *args), seed=10)
    want = mod.apply(jax_vars(v), *args)
    port = load(transformer.DecoderLayer(**kw),
                weights.decoder_layer_state_dict(v["params"]))
    with torch.no_grad():
        got, _ = port(
            torch.from_numpy(d["query"]), torch.from_numpy(d["query_pos"]),
            _flat_levels(d["levels"]), d["shapes"], torch.from_numpy(d["ref"]),
            torch.from_numpy(d["l2i"]), d["img"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    if name == "deform3d_mp":
        own = transformer.graph_neighbours(torch.from_numpy(d["ref"]), K).numpy()
        assert flipped_rows(own, jax_neighbours(d["ref"], K)) == 0
        # nearest first, self excluded
        assert (own != np.arange(own.shape[1])[None, :, None]).all()


def variant_config(c, **head_kw):
    """tiny_test_config (ResNet-18, 6 cameras of 3 current + 3 previous,
    64x128) with a setting's head fields, from either package."""
    cfg = c.tiny_test_config()
    return dataclasses.replace(
        cfg, head=dataclasses.replace(cfg.head, dropout=0.0, **head_kw))


def jax_model_and_weights(jcfg, images, l2i, seed):
    model = JaxGraphDETR4D(jcfg)
    v = perturb(jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.asarray(images),
                                    jnp.asarray(l2i)), seed=seed + 1)
    return model, v


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_full_model_matches_jax(setting):
    """A tiny GraphDETR4D of each setting: raw head outputs within 2e-4 of
    the JAX model's; MP's neighbour sets in every decoder layer equal to
    jax.lax.top_k's on the port's own reference points (0 flipped rows)."""
    jcfg = variant_config(jax_config, **SETTINGS[setting])
    tcfg = variant_config(port_config, **SETTINGS[setting])
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    batch = synthetic_batch(jcfg, seed=0)
    images, l2i = batch["images"], batch["lidar2img"]
    model, v = jax_model_and_weights(jcfg, images, l2i, seed=11)
    want = jax.jit(model.apply)(jax_vars(v), jnp.asarray(images),
                                jnp.asarray(l2i))

    port = GraphDETR4D(tcfg, device="cpu")
    port.load_state_dict(weights.state_dict_from_jax(v), strict=True)
    port.eval()
    graphs = []
    inner = transformer.graph_neighbours

    def record(ref, k):
        graphs.append((ref.numpy().copy(), inner(ref, k).numpy()))
        return graphs[-1][1]

    transformer.graph_neighbours = lambda ref, k: torch.from_numpy(record(ref, k))
    try:
        with torch.no_grad():
            got = port(torch.from_numpy(images), torch.from_numpy(l2i))
    finally:
        transformer.graph_neighbours = inner
    for key in ("all_cls_scores", "all_bbox_preds"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=HEAD_ATOL, err_msg=key)
    assert len(graphs) == (jcfg.head.num_decoder_layers
                           if setting == "deform3d_mp" else 0)
    k = jcfg.head.num_neighbors
    assert [flipped_rows(idx, jax_neighbours(ref, k)) for ref, idx in graphs] == \
        [0] * len(graphs)


@pytest.mark.parametrize("name", ["detr4d_res50", "detr4d_res50_mp", "detr3d_res50",
                                  "detr4d_res50_deform_pe_mp_testaug_2subset_12e",
                                  "graph_detr3d_res101"])
def test_variant_state_dict_from_jax(name):
    """At each registered variant config's full shapes (random arrays in
    flax's tree): state_dict_from_jax equals export_state_dict where that
    maps the variant (MP's neighbour branch it does not map: the port's
    module names are checked instead) and loads strictly."""
    jcfg = jax_configs.get_config(name)
    N, (H, W) = jcfg.head.num_cams, jcfg.img_size
    shapes = jax.eval_shape(JaxGraphDETR4D(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, N, H, W, 3)), jnp.zeros((1, N, 4, 4)))
    rng = np.random.RandomState(12)
    variables = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    got = weights.state_dict_from_jax(variables)
    if jcfg.head.attn_type == "deform3d_mp":
        xa = "pts_bbox_head.transformer.decoder.layers.0.attentions.1."
        for key in ("attention_weights_neighbor.weight", "output_weight.weight",
                    "position_encoder.4.bias", "deform_sampling_offsets.bias"):
            assert xa + key in got
        with pytest.raises(KeyError):
            export_state_dict(variables)
    else:
        want = export_state_dict(variables)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert ("pts_bbox_head.fpe.conv_reduce.weight" in got) == jcfg.head.with_pe
    model = GraphDETR4D(port_configs.get_config(name), device="cpu")
    model.load_state_dict(got, strict=True)
