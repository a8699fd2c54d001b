"""Each reference against the program's plain route (its CPU path: the
plain versions of K1 and K2, the per-camera compaction) in float32 at
tiny widths, and its float8 control away from both."""

import numpy as np
import pytest
import torch

import reference
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D
from harness.check import rel
from harness.traffic import surround_rig
from harness.weights import make_state_dict
from reference.common import Ref
from tiny import config, tiny_model


@pytest.mark.parametrize("name", ["flagship", "petrv2"])
def test_reference_matches_the_program_in_float32(name):
    cfg, model = tiny_model(name, ["bf16=False"])
    ref_mod = reference.load(config(name)["reference"])
    sd = make_state_dict(ref_mod.param_specs(model), 2 ** 31 + 7, "cpu")
    program = GraphDETR4D(cfg, device="cpu")
    program.load_state_dict(sd, strict=True)
    program.eval()
    h = model["head"]
    H, W = model["img_size"]
    g = torch.Generator().manual_seed(11)
    images = torch.randn(1, h["num_cams"], H, W, 3, generator=g) * 0.5
    l2i = torch.as_tensor(surround_rig(h["num_cams"], h["num_frame_cams"], (H, W),
                                       np.random.default_rng(3)))[None]
    extras = {k: torch.full((1,), v) for k, v in config(name)["extras"].items()}
    with torch.no_grad():
        out = program(images, l2i, **extras)
        feats = program.extract_feats(images)
        for precision, low, high in (("fp32", 0.0, 1e-5), ("fp8", 1e-3, 1.0)):
            ref = Ref(sd, precision)
            want = ref_mod.features(ref, model, images)
            cls, box = ref_mod.forward_feats(ref, model, want, l2i, extras)
            for a, b in zip(feats, want):
                assert low <= rel(a, b) <= high, precision
            assert low <= rel(out["all_cls_scores"], cls) <= high, precision
            assert low <= rel(out["all_bbox_preds"], box) <= high, precision
    assert float(out["cam_overflow"]) == 0.0
