"""Publish a checkpoint: the weights only, the output named by a content
hash (counterpart of tools/model_converters/publish_model.py; the
reference torch.saves the stripped state_dict and renames it by its
sha256 prefix).

    python -m graph_detr4d_tpu_torch.tools.publish_model \\
        --in-dir work_dirs/detr4d/checkpoints --out-dir release/detr4d \\
        [--step N] [--tiny | --config NAME] [--device cuda]

Reads the weights of --in-dir's checkpoint (train/checkpoint.py::
CheckpointManager.load_weights, the newest or --step), loads them into
the model of --tiny / --config on --device with strict=True (the JAX tool
restores them against its model's state), and writes them alone
(save_weights, step 0) under `--out-dir/published-<hash>`. The hash is
the first 8 hex digits of sha256 over the sorted state_dict keys, each
followed by its tensor's contiguous CPU bytes. It cannot equal the JAX
tool's hash, which runs over the flax tree's paths and layouts (ROADMAP
Queue 3 logs the departure).
"""

import argparse
import hashlib
import os

import torch


def state_dict_hash(state_dict) -> str:
    h = hashlib.sha256()
    for k in sorted(state_dict):
        h.update(k.encode())
        t = state_dict[k].detach().cpu().contiguous()
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:8]


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="graph_detr4d_tpu_torch.tools.publish_model")
    p.add_argument("--in-dir", required=True, help="checkpoint directory")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--config", default=None)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Returns the published directory."""
    from ..models.detector import GraphDETR4D
    from ..train.checkpoint import CheckpointManager
    from ..utils.device import resolve_device
    from .fuse_conv_bn import build_config

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = build_config(args)
    weights = CheckpointManager(args.in_dir, cfg).load_weights(
        args.step, map_location=device)
    if weights is None:
        raise SystemExit(f"no checkpoint found in {args.in_dir}")
    GraphDETR4D(cfg, device=device).load_state_dict(weights, strict=True)
    digest = state_dict_hash(weights)
    out = os.path.join(args.out_dir, f"published-{digest}")
    CheckpointManager(out, cfg).save_weights(0, weights)
    print(f"published weights-only checkpoint to {out} (sha {digest})")
    return out


if __name__ == "__main__":
    main()
