"""Serving export (counterpart of tools/export_model.py): write an artifact
that `serve.Engine.from_artifact` and tools/serve.py load.

    python -m graph_detr4d_tpu_torch.tools.export_model \\
        --config detr4d_res50_deform_pe_testaug_2subset_12e \\
        --checkpoint X.pth --out work_dirs/export [--uint8-input] [--streaming]
    python -m graph_detr4d_tpu_torch.tools.export_model --run work_dirs/export

The JAX artifact is a `jax.export` program with the weights inside. The
port's kernels are ctypes calls that torch.export cannot trace, so its
artifact is a directory of two files:

  * manifest.json: the JAX manifest's keys with their meanings (config,
    batch_size, num_cams, img_size, platforms, kernel_variants, inputs,
    extras, outputs, img_norm, streaming, size_bytes), plus `cfg_options`:
    with `config` (a registry name, or 'tiny' for --tiny) and
    img_norm.on_device they rebuild the model;
  * weights.pth: the reference-layout state_dict (torch.save; read back
    with weights_only=True).

`platforms` lists the devices the export verified the artifact on
(`--platforms`, default the `--device`); with --no-verify it is empty.
The verify runs before any file is written: on each platform the loaded
artifact's answers must equal direct inference bit for bit, and for
--streaming the two encoded halves plus the head must match the
monolithic forward in raw head-output space (final-layer sigmoid scores
and boxes) within 1e-4, computed in fp32 whatever the export's dtype;
the difference in the export's dtype is printed.

`--checkpoint` takes what tools/test.py takes: a port checkpoint directory
or a reference-layout .pth; without it the weights are weights.init_weights
at seed 0. `--device` defaults to cuda (without CUDA it raises); `--device
cpu` runs on the host.
"""

import argparse
import dataclasses
import io
import json
import os

import numpy as np
import torch

from ..serve import MANIFEST, WEIGHTS


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="graph_detr4d_tpu_torch.tools.export_model")
    p.add_argument("--config", default=None, help="named config")
    p.add_argument("--cfg-options", nargs="*", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--checkpoint", default=None,
                   help="a checkpoint directory of the port, or a "
                   "reference-layout .pth")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--platforms", default=None,
                   help="comma-separated devices (cpu, cuda) to verify the "
                   "artifact on; default: --device")
    p.add_argument("--out", default="work_dirs/export")
    p.add_argument("--streaming", action="store_true",
                   help="a temporal model served per video stream: the "
                   "server encodes each new frame once and reuses the "
                   "previous frame's features")
    p.add_argument("--uint8-input", action="store_true",
                   help="the artifact takes raw uint8 pixels and normalizes "
                   "on the device (ModelConfig.device_normalize)")
    p.add_argument("--no-verify", action="store_true",
                   help="skip the load-and-compare check")
    p.add_argument("--run", default=None, metavar="DIR",
                   help="load an artifact and run it on a synthetic batch")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def build_manifest(cfg, cfg_name, cfg_options, batch_size, streaming):
    """The artifact's manifest, without platforms and size_bytes."""
    from ..models.detector import GraphDETR4D
    from ..serve import extras_spec

    B, N = batch_size, cfg.head.num_cams
    H, W = cfg.img_size
    spec = extras_spec(cfg, B)
    manifest = {
        "config": cfg_name,
        "cfg_options": list(cfg_options or []),
        "batch_size": B,
        "num_cams": N,
        "img_size": [H, W],
        "platforms": [],
        "kernel_variants": {
            "dcn_gather": cfg.backbone.dcn_gather,
            "msda_impl": cfg.head.msda_impl,
            "msda_late_proj": cfg.head.msda_late_proj,
            "stem_s2d": cfg.backbone.stem_s2d,
        },
        "inputs": {
            "images": [[B, N, H, W, 3],
                       "uint8" if cfg.device_normalize else "float32"],
            "lidar2img": [[B, N, 4, 4], "float32"],
            **{name: [list(shape), "float32"] for name, shape in spec},
        },
        # extra inputs, in argument order after (images, lidar2img)
        "extras": [name for name, _ in spec],
        "outputs": ["bboxes", "scores", "labels", "valid"],
        "img_norm": {
            "mean": list(cfg.img_mean),
            "std": list(cfg.img_std),
            "bgr": cfg.img_bgr,
            "on_device": cfg.device_normalize,
        },
    }
    if streaming:
        nf = cfg.head.num_frame_cams
        if cfg.head.num_cams != 2 * nf:
            raise SystemExit(
                "--streaming needs num_cams == 2*num_frame_cams "
                f"(one cached sweep frame); got {cfg.head.num_cams} "
                f"vs num_frame_cams={nf}")
        # the features' shapes, from a shape-only pass of the conv stack
        # (on the meta device; a DCN conv's output has the shape of the
        # plain 3x3 conv in its place, whose meta kernel exists)
        model = GraphDETR4D(dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, use_dcn=False)), device="meta")
        img = torch.zeros(B, nf, H, W, 3, device="meta",
                          dtype=torch.uint8 if cfg.device_normalize
                          else torch.float32)
        feats = model.extract_feats(img)
        manifest["streaming"] = {
            "num_frame_cams": nf,
            "feat_keys": [f"feat{i}" for i in range(len(feats))],
            "feat_shapes": [list(f.shape) for f in feats],
            "feat_dtype": _dtype_name(feats[0].dtype),
        }
    return manifest


def _serialize(sd) -> bytes:
    buf = io.BytesIO()
    torch.save(sd, buf)
    return buf.getvalue()


def _raw_composition(model, images, l2i, kw, nf):
    feats = [torch.cat([c, p], dim=1) for c, p in zip(
        model.extract_feats(images[:, :nf]), model.extract_feats(images[:, nf:]))]
    return model.forward_feats(feats, l2i, **kw)


@torch.inference_mode()
def verify(cfg, manifest, blob, batch, extras, device):
    """Load the serialized artifact into an Engine on `device` and hold it
    to direct inference there (bit-equal), and for a streaming artifact
    the composition to the monolithic forward (raw head outputs)."""
    from ..models.detector import GraphDETR4D
    from ..serve import Engine

    sd = torch.load(io.BytesIO(blob), map_location="cpu", weights_only=True)
    engine = Engine(cfg, sd, device=device, manifest=manifest)
    got = engine.infer(batch["images"], batch["lidar2img"], extras)
    model = GraphDETR4D(cfg, device=device)
    model.load_state_dict(sd, strict=True)
    model.eval()
    images = torch.as_tensor(batch["images"]).to(device)
    l2i = torch.as_tensor(batch["lidar2img"]).to(device)
    kw = {n: torch.as_tensor(v).to(device)
          for (n, _), v in zip(engine.extras_spec, extras)}
    streaming = manifest.get("streaming")
    nf = cfg.head.num_frame_cams
    raw = (_raw_composition(model, images, l2i, kw, nf) if streaming
           else model(images, l2i, **kw))
    direct = engine._to_host(engine._answer(raw))
    for k in manifest["outputs"]:
        if not np.array_equal(got[k], direct[k]):
            raise AssertionError(f"artifact vs direct inference: {k} differs")
    gap = None
    if streaming:
        # the composition's semantics are dtype-free, so they are held in
        # fp32, where the halves compose exactly on the card; the export's
        # own dtype is reported. Under bf16 the conv stack rounds 6 and 12
        # cameras differently and a random-weight decoder amplifies that
        # past the JAX tool's 5e-2 in a few values (PERF.md, PR 11)
        gap = _composition_gap(_raw_composition(model, images, l2i, kw, nf)
                               if cfg.bf16 else raw, model(images, l2i, **kw))
        if cfg.bf16:
            model = GraphDETR4D(dataclasses.replace(cfg, bf16=False),
                                device=device)
            model.load_state_dict(sd, strict=True)
            model.eval()
            raw = _raw_composition(model, images, l2i, kw, nf)
        mono = model(images, l2i, **kw)
        for what, a, b in _final_layer_pairs(raw, mono):
            np.testing.assert_allclose(
                a.float().cpu().numpy(), b.float().cpu().numpy(), rtol=1e-4,
                atol=1e-4, err_msg=f"composition: {what}")
    del engine, model
    return gap


def _final_layer_pairs(a, b):
    return (("final-layer scores", torch.sigmoid(a["all_cls_scores"][-1]),
             torch.sigmoid(b["all_cls_scores"][-1])),
            ("final-layer boxes", a["all_bbox_preds"][-1],
             b["all_bbox_preds"][-1]))


def _composition_gap(raw, mono, tol=5e-2):
    """Per final-layer output, the max |composition - monolithic| and the
    count of values beyond tol + tol * |monolithic|."""
    gap = {}
    for what, a, b in _final_layer_pairs(raw, mono):
        d = (a.float() - b.float()).abs()
        gap[what] = {"max_abs": float(d.max()),
                     "beyond_5e-2": int((d > tol + tol * b.float().abs()).sum()),
                     "values": b.numel()}
    return gap


def export(args) -> dict:
    from ..config import tiny_test_config
    from ..configs import apply_overrides, get_config
    from ..data.synthetic import synthetic_batch
    from ..models.detector import GraphDETR4D
    from ..serve import synth_extra
    from ..utils.device import resolve_device
    from ..weights import init_weights
    from .test import load_checkpoint

    device = resolve_device(args.device)
    if args.tiny:
        cfg_name, cfg = "tiny", tiny_test_config()
        if args.cfg_options:
            cfg = apply_overrides(cfg, args.cfg_options)
    else:
        if not args.config:
            raise SystemExit("--config or --tiny required")
        cfg_name, cfg = args.config, get_config(args.config, args.cfg_options)
    if args.uint8_input:
        cfg = dataclasses.replace(cfg, device_normalize=True)
    platforms = ([] if args.no_verify else
                 [p.strip() for p in (args.platforms or device.type).split(",")
                  if p.strip()])

    if args.checkpoint:
        sd = load_checkpoint(args.checkpoint)
        print(f"loaded weights from {args.checkpoint}", flush=True)
    else:  # the JAX CLI's init with PRNGKey(0): seeded random weights
        model = GraphDETR4D(cfg, device="cpu")
        init_weights(model, 0)
        sd = model.state_dict()
        del model
    blob = _serialize(sd)
    manifest = build_manifest(cfg, cfg_name, args.cfg_options,
                              args.batch_size, args.streaming)
    manifest["size_bytes"] = len(blob)

    # verify BEFORE any file lands on disk, so that a failed check leaves
    # no complete-looking broken artifact behind
    batch = synthetic_batch(cfg, batch_size=args.batch_size)
    extras = [synth_extra(n, tuple(manifest["inputs"][n][0]))
              for n in manifest["extras"]]
    gaps = {p: verify(cfg, manifest, blob, batch, extras, resolve_device(p))
            for p in platforms}
    manifest["platforms"] = platforms

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, WEIGHTS), "wb") as f:
        f.write(blob)
    with open(os.path.join(args.out, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    print(json.dumps({"exported": args.out, **manifest}), flush=True)
    if platforms:
        print("verify: the loaded artifact matches direct inference"
              + ("; the streaming composition matches the monolithic "
                 "forward in fp32 (raw head outputs)" if args.streaming
                 else ""), flush=True)
    if args.streaming:
        print(json.dumps({"composition_gap_in_export_dtype": gaps}),
              flush=True)
    return manifest


def run_artifact(out_dir, device):
    """Load an artifact and answer one synthetic request."""
    from ..serve import Engine, synth_extra

    engine = Engine.from_artifact(out_dir, device=device)
    m = engine.manifest
    B, N = m["batch_size"], m["num_cams"]
    H, W = m["img_size"]
    rng = np.random.RandomState(0)
    if m["inputs"]["images"][1] == "uint8":
        images = rng.randint(0, 256, (B, N, H, W, 3), np.int64).astype(np.uint8)
    else:
        images = rng.randn(B, N, H, W, 3).astype(np.float32)
    l2i = np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1))
    det = engine.infer(images, l2i, [synth_extra(n, s)
                                     for n, s in engine.extras_spec])
    assert np.isfinite(det["bboxes"][det["valid"]]).all()
    out = {"artifact": out_dir, "platforms": m["platforms"],
           "streaming": bool(m.get("streaming")),
           "detections_shape": list(det["bboxes"].shape),
           "n_valid": int(det["valid"].sum())}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    args = parse_args(argv)
    if args.run:
        return run_artifact(args.run, args.device)
    return export(args)


if __name__ == "__main__":
    main()
