"""The library helpers, against the JAX package's on the CPU, inputs
seeded by numpy:

  * core/coder.py::nms_free_cls_decode (NMSFreeClsCoder): the same
    indices and labels, scores within 1e-6, also with tied scores (the
    lower query first, as jax.lax.top_k) and on a batch;
  * geometry/projection.py: project_points_to_cameras (loc within 1e-5
    in the image and 1e-5 relative elsewhere in front of the camera, the
    same mask, points kept 1e-3 away from the image edges), the
    cross-attentions' one projection; points_img2cam within 1e-4 for
    3x3, 3x4 and 4x4 intrinsics; inv3x3 and normalize_points;
  * models/positional.py::LearnedPositionalEncoding3D: exact, its tables
    carried across from the flax params by weights.learned_pe_state_dict.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from graph_detr4d_tpu.core import coder as jax_coder  # noqa: E402
from graph_detr4d_tpu.geometry import projection as jax_proj  # noqa: E402
from graph_detr4d_tpu.models import positional as jax_positional  # noqa: E402
from graph_detr4d_tpu_torch import weights  # noqa: E402
from graph_detr4d_tpu_torch.config import ModelConfig  # noqa: E402
from graph_detr4d_tpu_torch.core import coder  # noqa: E402
from graph_detr4d_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from graph_detr4d_tpu_torch.geometry import projection  # noqa: E402
from graph_detr4d_tpu_torch.models.positional import LearnedPositionalEncoding3D  # noqa: E402

PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)


# ----------------------------------------------------- nms_free_cls_decode
def cls_inputs(seed, Q=60, C=10, ties=False):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(Q, C + 1) * 2).astype(np.float32)
    if ties:  # whole rows repeated: equal per-query scores
        logits[1::3] = logits[0::3][: len(logits[1::3])]
        logits[:, 3] = logits[:, 5]  # equal classes: the first one wins
    codes = rng.randn(Q, 10).astype(np.float32)
    codes[:, :3] *= 40.0
    return logits, codes


@pytest.mark.parametrize("ties", [False, True])
def test_nms_free_cls_decode_matches_jax(ties):
    logits, codes = cls_inputs(3, ties=ties)
    kw = dict(max_num=24, score_threshold=0.05)
    want = jax_coder.nms_free_cls_decode(jnp.asarray(logits), jnp.asarray(codes), **kw)
    got = coder.nms_free_cls_decode(torch.as_tensor(logits), torch.as_tensor(codes), **kw)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-6)
    np.testing.assert_allclose(got.bboxes.numpy(), np.asarray(want.bboxes),
                               rtol=1e-6, atol=1e-5)
    # the same queries, in the same order: their codes decode to equal boxes
    probs = jax.nn.softmax(jnp.asarray(logits), -1)[:, :-1].max(-1)
    _, idx = jax.lax.top_k(probs, 24)
    want_boxes = np.asarray(jax_coder.denormalize_bbox(jnp.asarray(codes)[idx]))
    np.testing.assert_allclose(got.bboxes.numpy(), want_boxes, rtol=1e-6, atol=1e-5)
    if ties:
        tied = np.unique(np.asarray(want.scores), return_counts=True)[1]
        assert tied.max() > 1  # the case holds ties at the top


def test_nms_free_cls_decode_batched():
    per = [cls_inputs(s) for s in (4, 5)]
    logits = torch.as_tensor(np.stack([p[0] for p in per]))
    codes = torch.as_tensor(np.stack([p[1] for p in per]))
    got = coder.nms_free_cls_decode(logits, codes, max_num=16)
    for b, (lg, cd) in enumerate(per):
        want = jax_coder.nms_free_cls_decode(jnp.asarray(lg), jnp.asarray(cd),
                                             max_num=16)
        np.testing.assert_array_equal(got.labels[b].numpy(), np.asarray(want.labels))
        np.testing.assert_allclose(got.scores[b].numpy(), np.asarray(want.scores),
                                   atol=1e-6)


# ----------------------------------------------------------- projection
def projection_inputs(seed, B=2, P=400):
    cfg = ModelConfig()
    l2i = synthetic_batch(cfg, B, seed=seed)["lidar2img"].astype(np.float32)
    rng = np.random.RandomState(seed)
    pts = rng.uniform(PC_RANGE[:3], PC_RANGE[3:], (B, P, 3)).astype(np.float32)
    return pts, l2i, cfg.img_size


def test_project_points_to_cameras_matches_jax():
    pts, l2i, img_hw = projection_inputs(0)
    loc_j, mask_j = (np.asarray(a) for a in jax_proj.project_points_to_cameras(
        jnp.asarray(pts), jnp.asarray(l2i), img_hw))
    loc, mask = projection.project_points_to_cameras(
        torch.as_tensor(pts), torch.as_tensor(l2i), img_hw)
    loc, mask = loc.numpy(), mask.numpy()
    # the points whose loc lies 1e-3 or more from every image edge
    away = (np.abs(loc_j) > 1e-3).all(-1) & (np.abs(loc_j - 1.0) > 1e-3).all(-1)
    assert away.mean() > 0.99 and mask_j.sum() > 50
    np.testing.assert_array_equal(mask[away], mask_j[away])
    # in the image (what the sampler reads) within 1e-5; elsewhere in front
    # of the camera, where |loc| reaches ~50 and is no divide by eps,
    # within 1e-5 of its magnitude
    valid = mask_j > 0
    np.testing.assert_allclose(loc[valid], loc_j[valid], atol=1e-5)
    z = np.einsum("bnij,bpj->bnpi", l2i.astype(np.float64),
                  np.concatenate([pts, np.ones_like(pts[..., :1])], -1))[..., 2]
    front = z > 0.5
    np.testing.assert_allclose(loc[front], loc_j[front], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(3, 3), (3, 4), (4, 4)])
def test_points_img2cam_matches_jax(shape):
    rng = np.random.RandomState(shape[1])
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 1260.0, 1250.0, 800.0, 450.0
    K[:3, 3] = rng.uniform(-1, 1, 3)
    cam2img = K[: shape[0], : shape[1]]
    uvd = np.stack([rng.uniform(0, 1600, 64), rng.uniform(0, 900, 64),
                    rng.uniform(1, 60, 64)], 1).astype(np.float32)
    want = np.asarray(jax_proj.points_img2cam(jnp.asarray(uvd), jnp.asarray(cam2img)))
    got = projection.points_img2cam(torch.as_tensor(uvd), torch.as_tensor(cam2img))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_inv3x3_and_normalize_points_match_jax():
    rng = np.random.RandomState(7)
    m = (rng.randn(5, 4, 3, 3) + 3 * np.eye(3)).astype(np.float32)
    want = np.asarray(jax_proj.inv3x3(jnp.asarray(m)))
    got = projection.inv3x3(torch.as_tensor(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got @ m, np.broadcast_to(np.eye(3), m.shape), atol=1e-5)
    pts = rng.uniform(-60, 60, (3, 50, 3)).astype(np.float32)
    want = np.asarray(jax_proj.normalize_points(jnp.asarray(pts), PC_RANGE))
    got = projection.normalize_points(torch.as_tensor(pts), PC_RANGE).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ------------------------------------------------- learned positional PE
def test_learned_positional_encoding_3d_matches_jax():
    kw = dict(num_feats=16, row_num_embed=20, col_num_embed=30, cam_num_embed=12)
    jmod = jax_positional.LearnedPositionalEncoding3D(**kw)
    params = jmod.init(jax.random.PRNGKey(3), 2, 6, 8, 20)["params"]
    want = np.asarray(jmod.apply({"params": params}, 2, 6, 8, 20))
    mod = LearnedPositionalEncoding3D(**kw, device="cpu")
    first = {k: v.clone() for k, v in mod.state_dict().items()}
    assert set(first) == {"row_embed.weight", "col_embed.weight", "cam_embed.weight"}
    assert all(0 <= float(v.min()) and float(v.max()) < 1 for v in first.values())
    again = LearnedPositionalEncoding3D(**kw, device="cpu").state_dict()
    assert all(torch.equal(first[k], again[k]) for k in first)  # seeded
    mod.load_state_dict(weights.learned_pe_state_dict(params), strict=True)
    got = mod(2, 6, 8, 20)
    assert got.shape == (2, 6, 8, 20, 48)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LearnedPositionalEncoding3D(**kw)
