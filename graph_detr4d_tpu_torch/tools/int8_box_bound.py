"""Bound the int8 DCN gather table at box level (counterpart of
tools/int8_box_bound.py).

The same weights and inputs run through the exact DCN path and the
opt-in `backbone.dcn_gather=int8` path (K3 on the DCN convs whose input
grid is large enough, ops/deform_conv.select_variant); over the NMS-free
coder's top-max_num (query, class) selection of the final decoder layer
it reports:
  * the selection churn: how many of one run's selected pairs the other
    run does not select;
  * over the pairs both select, the max |delta| of the centre (m), size,
    yaw (rad, wrapped), velocity and score.

    python -m graph_detr4d_tpu_torch.tools.int8_box_bound \\
        [--h 640 --w 1600] [--tiny] [--device cuda]

The default is the JAX tool's shape: 6 cameras at 640x1600,
cam_capacity 0.5, bf16, seeded random weights; `--tiny` is the tiny test
config with DCN. `box_drift` is the one copy of the measure: chip_smoke.py's
phase serve_int8 reports it on the card.
"""

import argparse
import dataclasses

import numpy as np
import torch

from ..geometry.boxes import denormalize_bbox


def top_selection(cls, codes, max_num):
    """The NMS-free coder's ranking: the top `max_num` flat (query, class)
    indices by sigmoid score (stable), their scores and decoded boxes.
    cls (B, Q, classes) logits, codes (B, Q, code)."""
    scores = torch.sigmoid(cls.float()).flatten(-2)
    top, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top, idx = top[..., :max_num], idx[..., :max_num]
    C = cls.shape[-1]
    q = (idx // C)[..., None].expand(*idx.shape, codes.shape[-1])
    return idx, top, denormalize_bbox(torch.gather(codes.float(), -2, q))


def box_drift(ref, got, max_num):
    """The box-level drift of `got` against `ref`, each a final layer's
    (logits (1, Q, classes), codes (1, Q, code)): top-max_num selection
    churn, and the max |d| of centre (m), size, yaw (rad, wrapped),
    velocity and score over the (query, class) pairs both select."""
    ia, sa, ba = (t[0].cpu() for t in top_selection(*ref, max_num))
    ib, sb, bb = (t[0].cpu() for t in top_selection(*got, max_num))
    pos_b = {int(v): j for j, v in enumerate(ib)}
    churn = len(set(ia.tolist()) - set(ib.tolist()))
    d = dict.fromkeys(("center", "size", "yaw", "velocity", "score"), 0.0)
    matched = 0
    for i, v in enumerate(ia.tolist()):
        j = pos_b.get(v)
        if j is None:
            continue
        matched += 1
        d["center"] = max(d["center"], (ba[i, :3] - bb[j, :3]).abs().max().item())
        d["size"] = max(d["size"], (ba[i, 3:6] - bb[j, 3:6]).abs().max().item())
        dy = abs(ba[i, 6].item() - bb[j, 6].item())
        d["yaw"] = max(d["yaw"], min(dy, abs(dy - 2 * np.pi)))
        d["velocity"] = max(d["velocity"], (ba[i, 7:9] - bb[j, 7:9]).abs().max().item())
        d["score"] = max(d["score"], abs(sa[i].item() - sb[j].item()))
    return {"selected": max_num, "churn": churn, "matched": matched,
            "max_abs_delta": d}


def build_config(args):
    """The JAX tool's configs: the tiny test config with DCN, or 6
    cameras at --h x --w, cam_capacity 0.5, bf16."""
    from ..config import HeadConfig, ModelConfig, tiny_test_config

    if args.tiny:
        cfg = tiny_test_config()
        return dataclasses.replace(
            cfg, backbone=dataclasses.replace(cfg.backbone, use_dcn=True))
    return ModelConfig(
        head=HeadConfig(num_cams=6, with_detach=False, cam_capacity=0.5),
        img_size=(args.h, args.w), bf16=True)


def final_layer(model, images, lidar2img):
    """The final decoder layer's (logits, codes) of one eval forward."""
    with torch.no_grad():
        out = model(images, lidar2img)
    return out["all_cls_scores"][-1].float(), out["all_bbox_preds"][-1].float()


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="graph_detr4d_tpu_torch.tools.int8_box_bound")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--h", type=int, default=640)
    p.add_argument("--w", type=int, default=1600)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    from ..data.synthetic import synthetic_batch
    from ..models.detector import GraphDETR4D
    from ..utils.device import resolve_device
    from ..weights import init_weights

    args = parse_args(argv)
    cfg = build_config(args)
    device = resolve_device(args.device)
    seeded = GraphDETR4D(cfg, device="cpu")
    init_weights(seeded, 0)
    sd = seeded.state_dict()
    del seeded
    batch = synthetic_batch(cfg, 1)
    images = torch.as_tensor(batch["images"], device=device)
    l2i = torch.as_tensor(batch["lidar2img"], device=device)
    outs = {}
    for variant in ("shift4", "int8"):
        vcfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, dcn_gather=variant))
        model = GraphDETR4D(vcfg, device=device)
        model.load_state_dict(sd, strict=True)
        outs[variant] = final_layer(model.eval(), images, l2i)
        del model
    drift = box_drift(outs["shift4"], outs["int8"], cfg.coder.max_num)
    K, d = drift["selected"], drift["max_abs_delta"]
    print(f"top-{K} selection churn: [{drift['churn']}] of {K} "
          f"({100.0 * drift['churn'] / K:.1f}% max)")
    print(f"matched {drift['matched']}/{K}: max |d center| {d['center']:.4f} m, "
          f"|d size| {d['size']:.4f}, |d yaw| {d['yaw']:.4f} rad, "
          f"|d vel| {d['velocity']:.4f}, |d score| {d['score']:.5f}")
    return drift


if __name__ == "__main__":
    main()
