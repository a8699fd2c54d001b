"""The model FLOPs of one request or step, counted on the reference.

    python benchmark/flops/count.py CONFIG ENTRY

prints the FLOPs of one request of ENTRY (`infer_stream`: the backbone
and neck on one frame's cameras, the head on the whole rig; `infer`: all
of it on the whole rig) of the configuration `benchmark/configs/
CONFIG.json`, counted once here and written into the cell's file, so no
run pays for them. The reference runs on the `meta` device, so nothing
is computed: `torch.utils.flop_counter.FlopCounterMode` counts its
convolutions (a matrix product per tap) and matrix products, the
modulated deformable convolution's product included, which is K2's
formula 2 M 9 Cin Cout. K1's samples are gathers the counter does not
see; they count by K1's formula (graph_detr4d_tpu_torch/tools/
get_flops.py:27-52): 2 x head_dim a bilinear corner, here over every
sample of every query in every camera, the work the model asks for
whatever a kernel skips. The count is the same whatever implements the
model, so a share of the peak made from it does not move when the
implementation changes.
"""

import json
import os
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from reference import load as load_reference  # noqa: E402
from reference.common import Ref  # noqa: E402


def k1_flops(model: dict) -> int:
    """K1's formula over one head pass: 2 hd FLOPs for each of the 4
    corners of every sample, all layers, queries and cameras."""
    h = model["head"]
    if model["head_type"] != "detr4d_pe":
        return 0
    samples = (h["num_cams"] * h["num_query"] * h["num_heads"]
               * h["num_levels"] * h["num_points"])
    hd = h["embed_dims"] // h["num_heads"]
    return h["num_decoder_layers"] * samples * 4 * 2 * hd


def request_flops(config: dict, entry: str) -> int:
    """FLOPs of one request of `entry` at batch 1."""
    model = config["model"]
    ref_mod = load_reference(config["reference"])
    specs = ref_mod.param_specs(model)
    sd = {name: torch.empty(shape, device="meta") for name, shape, _ in specs}
    ref = Ref(sd)
    h = model["head"]
    H, W = model["img_size"]
    new = h["num_frame_cams"] if entry == "infer_stream" else h["num_cams"]
    images = torch.empty(1, new, H, W, 3, device="meta")
    lidar2img = torch.empty(1, h["num_cams"], 4, 4, device="meta")
    extras = {k: torch.empty(1, device="meta") for k in config.get("extras", {})}
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        feats = ref_mod.features(ref, model, images)
        feats = [torch.cat([f] * (h["num_cams"] // new), dim=1) for f in feats]
        ref_mod.forward_feats(ref, model, feats, lidar2img, extras)
    return int(counter.get_total_flops()) + k1_flops(model)


if __name__ == "__main__":
    name, entry = sys.argv[1], sys.argv[2]
    with open(os.path.join(os.path.dirname(HERE), "configs", name + ".json")) as f:
        cfg = json.load(f)
    print(request_flops(cfg, entry))
