"""Streaming and test-time-augmentation serving of the port against the JAX
package, fp32 on the CPU (the kernels' plain versions), on
tiny_test_config (ResNet-18; 6 cameras = 3 of the current frame + 3 of the
previous; 64x128).

  * serve.Engine.infer_stream: two requests of one stream equal infer on
    the concatenated frames, the first request reusing its own frame as
    the previous one; its answer equals the JAX model's forward_feats on
    the same concatenated features, decoded; the cache evicts the least
    recently used stream at max_streams, and reset_stream drops one;
  * GraphDETR4D.aug_forward and parallel/step.py's build_tta_eval_step
    against the JAX aug_forward and build_tta_eval_step (per-copy
    calibrations, head outputs averaged), and build_eval_step against
    the JAX build_eval_step.

Raw head outputs are held to atol 2e-4 (tests/test_golden_full_model.py);
decoded answers as tests/test_torch_slice.py holds them.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_modules import jax_vars  # noqa: E402
from tests.test_torch_variants import jax_model_and_weights, variant_config  # noqa: E402

from graph_detr4d_tpu import config as jax_config  # noqa: E402
from graph_detr4d_tpu.core.coder import decode_batch as jax_decode  # noqa: E402
from graph_detr4d_tpu.data.synthetic import synthetic_batch  # noqa: E402
from graph_detr4d_tpu.parallel import step as jax_step  # noqa: E402
from graph_detr4d_tpu_torch import config as port_config  # noqa: E402
from graph_detr4d_tpu_torch.core.coder import decode_batch  # noqa: E402
from graph_detr4d_tpu_torch.parallel import step as port_step  # noqa: E402
from graph_detr4d_tpu_torch.serve import Engine  # noqa: E402
from graph_detr4d_tpu_torch.weights import state_dict_from_jax  # noqa: E402

ATOL = 2e-4
DET_KEYS = ("bboxes", "scores", "labels", "valid")


@pytest.fixture(scope="module")
def setup():
    """The JAX model and its weights, a port Engine with the same weights,
    and two synthetic requests (each a full 6-camera rig)."""
    jcfg, tcfg = variant_config(jax_config), variant_config(port_config)
    batches = [synthetic_batch(jcfg, seed=s) for s in (0, 1)]
    model, v = jax_model_and_weights(jcfg, batches[0]["images"],
                                     batches[0]["lidar2img"], seed=21)
    engine = Engine(tcfg, state_dict_from_jax(v), device="cpu", max_streams=2)
    return jcfg, tcfg, model, v, engine, batches


def frames(batches):
    """The current frame's cameras of each request: A, B."""
    nf = batches[0]["images"].shape[1] // 2
    return [b["images"][:, :nf] for b in batches]


def assert_same_answer(got, want, atol=1e-5):
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert got["valid"].any()
    for key in ("bboxes", "scores"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol,
                                   err_msg=key)


def test_two_stream_requests_equal_infer_on_the_concatenated_frames(setup):
    _, _, _, _, engine, batches = setup
    a, b = frames(batches)
    l2i = batches[1]["lidar2img"]
    engine.reset_stream("s")
    first = engine.infer_stream(a, l2i, stream="s")
    second = engine.infer_stream(b, l2i, stream="s")
    assert_same_answer(first, engine.infer(np.concatenate([a, a], 1), l2i))
    assert_same_answer(second, engine.infer(np.concatenate([b, a], 1), l2i))
    assert second["cam_overflow"] == 0.0


def test_streamed_head_equals_jax_forward_feats(setup):
    """The second request's answer against the JAX model's extract_feats
    of each frame, concatenated [current | previous], through its
    forward_feats and decode."""
    jcfg, _, model, v, engine, batches = setup
    a, b = frames(batches)
    l2i = batches[1]["lidar2img"]
    engine.reset_stream("j")
    engine.infer_stream(a, l2i, stream="j")
    got = engine.infer_stream(b, l2i, stream="j")

    def head(v, a, b, l2i):
        fa, fb = (model.apply(v, x, False, None, method=model.extract_feats)
                  for x in (a, b))
        feats = [jnp.concatenate([y, x], axis=1) for x, y in zip(fa, fb)]
        return model.apply(v, feats, l2i, method=model.forward_feats)

    out = jax.jit(head)(jax_vars(v), jnp.asarray(a), jnp.asarray(b),
                        jnp.asarray(l2i))
    c = jcfg.coder
    want = jax_decode(out, max_num=c.max_num,
                      post_center_range=c.post_center_range,
                      score_threshold=c.score_threshold)._asdict()
    want = {k: np.asarray(want[k]) for k in DET_KEYS}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    valid = want["valid"]
    np.testing.assert_allclose(got["bboxes"][valid], want["bboxes"][valid],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=ATOL)


def test_stream_cache_evicts_least_recently_used_and_resets(setup):
    _, _, _, _, engine, batches = setup
    a, b = frames(batches)
    l2i = batches[0]["lidar2img"]
    for s in list(engine._streams):
        engine.reset_stream(s)
    fresh = engine.infer_stream(b, l2i, stream="x")  # prev = its own frame
    engine.infer_stream(a, l2i, stream="y")
    engine.infer_stream(a, l2i, stream="x")  # x used last: y is the oldest
    engine.infer_stream(a, l2i, stream="z")  # max_streams 2: y evicted
    assert list(engine._streams) == ["x", "z"]
    again = engine.infer_stream(b, l2i, stream="y")  # y starts over
    assert_same_answer(again, fresh, atol=0.0)
    assert list(engine._streams) == ["z", "y"]
    assert engine.reset_stream("z") is True
    assert engine.reset_stream("z") is False
    assert list(engine._streams) == ["y"]


def test_aug_forward_and_tta_step_match_jax(setup):
    """Two different copies, each with its own calibration: the mean of
    the two forwards' head outputs, against the JAX aug_forward and the
    decoded JAX build_tta_eval_step; identical copies equal one forward;
    build_eval_step against the JAX build_eval_step."""
    jcfg, tcfg, model, v, engine, batches = setup
    images = np.stack([b["images"] for b in batches])
    l2is = np.stack([b["lidar2img"] for b in batches])
    want = jax.jit(lambda v, i, l: model.apply(
        v, list(i), l, method=model.aug_forward))(
            jax_vars(v), jnp.asarray(images), jnp.asarray(l2is))
    port = engine.model
    with torch.no_grad():
        got = port.aug_forward([torch.from_numpy(x) for x in images],
                               torch.from_numpy(l2is))
        one = port(torch.from_numpy(images[0]), torch.from_numpy(l2is[0]))
        same = port.aug_forward([torch.from_numpy(images[0])] * 2,
                                torch.from_numpy(l2is[0]))
        two = port(torch.from_numpy(images[1]), torch.from_numpy(l2is[1]))
    for key in ("all_cls_scores", "all_bbox_preds"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=ATOL, err_msg=key)
        torch.testing.assert_close(same[key], one[key], rtol=0, atol=1e-6)
        torch.testing.assert_close(got[key], (one[key] + two[key]) / 2.0,
                                   rtol=0, atol=1e-6)

    params = jax_vars(v)
    jdet = jax_step.build_tta_eval_step(model, jcfg)(
        params["params"], params["batch_stats"], jnp.asarray(images),
        jnp.asarray(l2is), {})
    tdet, overflow = port_step.build_tta_eval_step(port, tcfg)(
        torch.from_numpy(images), torch.from_numpy(l2is))
    assert float(overflow) == float(got["cam_overflow"])
    c = tcfg.coder
    assert_det_close(tdet, jdet)
    assert_det_close(decode_batch(got, max_num=c.max_num,
                                  post_center_range=c.post_center_range,
                                  score_threshold=c.score_threshold), jdet)
    batch = {"images": images[0], "lidar2img": l2is[0]}
    jdet = jax_step.build_eval_step(model, jcfg)(
        params["params"], params["batch_stats"],
        {k: jnp.asarray(x) for k, x in batch.items()})
    tdet, overflow = port_step.build_eval_step(port, tcfg)(
        {k: torch.from_numpy(x) for k, x in batch.items()})
    assert float(overflow) == float(one["cam_overflow"])
    assert_det_close(tdet, jdet)


def assert_det_close(got, want):
    got, want = got._asdict(), want._asdict()
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    assert valid.any()
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    np.testing.assert_allclose(got["bboxes"].numpy()[valid],
                               np.asarray(want["bboxes"])[valid], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=0, atol=ATOL)
