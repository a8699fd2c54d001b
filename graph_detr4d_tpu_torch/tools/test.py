"""Eval CLI (counterpart of tools/test.py; reference tools/test.py): run
inference over a dataset, decode the NMS-free detections, compute the
nuScenes metrics (mAP / NDS), optionally write the results json and the
official submission.

    python -m graph_detr4d_tpu_torch.tools.test \\
        --config detr4d_res50_deform_pe_testaug_2subset_12e \\
        --ann-file data/nuscenes/..._val.pkl --checkpoint X.pth \\
        [--tta-resizes 1.0,0.95,1.05] [--out results.json] [--format-nusc DIR]

`--checkpoint` is a directory of the port's checkpoints
(WORK_DIR/checkpoints: the latest step's weights) or a `.pth` in the
reference layout (an upstream mmdet3d checkpoint, or one the port saved).
The JAX CLI's flags, with the same names and meanings, plus `--device`
(default cuda: without CUDA it raises; `--device cpu` runs on the host).
`--cam-parallel` above 1 is ROADMAP Queue 1 item 4 and exits with an
error. With `--tiny`, `--cfg-options` still applies.

Host decoding of the next samples runs on a thread (PrefetchIterator)
while the card evaluates the current one, and the device-to-host read of
a sample's detections waits until the next sample is queued. `main(argv)`
returns {'metrics', 'results', 'cam_overflow', 'timing'}.
"""

import argparse
import json
import os

import numpy as np
import torch

from ..models.detector import model_extras
from .train import build_config, refuse_cam_parallel


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="graph_detr4d_tpu_torch.tools.test")
    p.add_argument("--config", default=None, help="named config")
    p.add_argument("--cfg-options", nargs="*", default=None)
    p.add_argument("--ann-file", default=None)
    p.add_argument("--dataset", default="nuscenes",
                   choices=["nuscenes", "custom6cam"],
                   help="custom6cam: the internal-dataset format with "
                   "center2lidar calibration")
    p.add_argument("--checkpoint", default=None,
                   help="a checkpoint directory of the port, or a "
                   "reference-layout .pth")
    p.add_argument("--img-h", type=int, default=320)
    p.add_argument("--img-w", type=int, default=800)
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--sweeps-num", type=int, default=1,
                   help="previous frames per sample (loading.py sweeps_num)")
    p.add_argument("--out", default=None, help="write results json here")
    p.add_argument("--format-nusc", default=None,
                   help="directory for the official-submission "
                   "results_nusc.json (boxes converted lidar -> global)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--no-temporal", action="store_true",
                   help="sample only the current frame's cameras")
    p.add_argument("--tta-resizes", default=None,
                   help="comma-separated ida resize multipliers, e.g. "
                   "'1.0,0.95,1.05': one resized copy each, with its own "
                   "calibration, head outputs averaged")
    p.add_argument("--cam-parallel", type=int, default=1,
                   help="camera-axis model parallelism over this many GPUs "
                   "(not ported: ROADMAP Queue 1 item 4)")
    p.add_argument("--native-loader", action="store_true",
                   help="decode and resize through the C++ loader; "
                   "incompatible with --tta-resizes")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.native_loader and args.tta_resizes:
        p.error("--native-loader and --tta-resizes are incompatible (TTA "
                "copies reuse the python path's decoded images)")
    return args


def load_checkpoint(path: str):
    """The weights of a port checkpoint directory (its latest step) or of
    a reference-layout .pth."""
    from ..train.checkpoint import CheckpointManager
    from ..weights import load_reference_checkpoint

    if os.path.isdir(path):
        sd = CheckpointManager(path).load_weights()
        if sd is None:
            raise FileNotFoundError(f"no checkpoint in {path}")
        return sd
    return load_reference_checkpoint(path)


def _model_inputs(batch):
    # the inputs the port's models take: images, lidar2img and the model
    # extras the batch carries (PETRv2's mean_time_stamp, the camera-aware
    # intrinsics and ida_scale, scale_pred's depth_factors)
    return {"images": batch["images"], "lidar2img": batch["lidar2img"],
            **model_extras(batch)}


def run_eval(model, cfg, items) -> dict:
    """items yields (token, host batch of one sample, gt_attrs or None,
    ego_xy or None). Returns {'metrics', 'results', 'cam_overflow',
    'timing'}: timing holds, per sample, host_ms (producing the batch, on
    the prefetch thread), h2d_bytes, and on a CUDA device h2d_ms and
    forward_ms (CUDA events around the copies, and from there to the end
    of the forward and decode)."""
    from ..eval.nuscenes_metrics import DetectionEvaluator
    from ..parallel.step import build_eval_step, build_tta_eval_step
    from ..parallel.transfer import batch_bytes, cast_for_transfer, to_device
    from ..train.trainer import PrefetchIterator, timed

    device = next(model.parameters()).device
    cuda = device.type == "cuda"
    eval_step = build_eval_step(model, cfg)
    tta_step = build_tta_eval_step(model, cfg)
    evaluator = DetectionEvaluator()
    results, overflow = [], []
    timing = {"host_ms": [], "h2d_bytes": [], "h2d_ms": [], "forward_ms": []}
    pending = []

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def submit(token, batch, gt_attrs, ego_xy):
        host = cast_for_transfer(_model_inputs(batch), cfg.bf16)
        timing["h2d_bytes"].append(batch_bytes(host))
        dev, copy_events, pinned = to_device(host, device)
        ev = list(copy_events) if cuda else []
        if dev["images"].dim() == 6:  # (A, B, N, H, W, 3): TTA copies
            det, cam_overflow = tta_step(dev["images"], dev["lidar2img"],
                                         model_extras(dev))
        else:
            det, cam_overflow = eval_step(dev)
        ev += [event()] if cuda else []
        pending.append((det, cam_overflow, batch, token, gt_attrs, ego_xy,
                        ev, pinned))

    def finish(det, cam_overflow, batch, token, gt_attrs, ego_xy, ev, pinned):
        det = {k: v.cpu().numpy() for k, v in det._asdict().items()}
        overflow.append(float(cam_overflow))
        if ev:
            timing["h2d_ms"].append(ev[0].elapsed_time(ev[1]))
            timing["forward_ms"].append(ev[1].elapsed_time(ev[2]))
        keep = det["valid"][0]
        gkeep = np.asarray(batch["gt_valid"][0]) > 0
        boxes, labels = det["bboxes"][0][keep], det["labels"][0][keep]
        scores = det["scores"][0][keep]
        evaluator.add_sample(
            boxes, labels, scores,
            batch["gt_bboxes"][0][gkeep], batch["gt_labels"][0][gkeep],
            gt_attrs=(None if gt_attrs is None
                      else np.asarray(gt_attrs, object)[gkeep]),
            ego_xy=ego_xy)
        results.append({"token": token, "boxes": boxes.tolist(),
                        "scores": scores.tolist(), "labels": labels.tolist()})

    prefetch = PrefetchIterator(timed(items), depth=2,
                                name="eval-host-pipeline")
    try:
        for (token, batch, gt_attrs, ego_xy), host_s in prefetch:
            timing["host_ms"].append(1e3 * host_s)
            submit(token, batch, gt_attrs, ego_xy)
            # one sample in flight: read the previous one's answer now
            while len(pending) > 1:
                finish(*pending.pop(0))
        while pending:
            finish(*pending.pop(0))
    finally:
        prefetch.close()
    if not cuda:
        del timing["h2d_ms"], timing["forward_ms"]
    return {"metrics": evaluator.evaluate(), "results": results,
            "cam_overflow": overflow, "timing": timing}


def dataset_items(ds, cfg, n, *, dataset="nuscenes", temporal=True,
                  tta_mults=None, native_loader=False):
    """The first n samples of a dataset through build_batch (eval)."""
    from ..data.pipeline import build_batch

    for i in range(n):
        s = ds.sample(i, temporal=temporal) if dataset == "nuscenes" \
            else ds.sample(i)
        b = build_batch(
            [s], cfg.img_size, training=False,
            img_norm=(cfg.img_mean, cfg.img_std, cfg.img_bgr),
            tta_resize_mults=tta_mults,
            device_normalize=cfg.device_normalize, use_native=native_loader)
        yield (s.get("token", f"sample-{i}"), b, s.get("gt_attrs"),
               s.get("ego_xy"))


def evaluate_dataset(model, cfg, ds, n, **kw) -> dict:
    """run_eval over the first n samples of ds (the train CLI's eval hook)."""
    return run_eval(model, cfg, dataset_items(ds, cfg, n, **kw))


def main(argv=None):
    args = parse_args(argv)
    refuse_cam_parallel(args)
    from ..data.pipeline import shutdown_decode_pool
    from ..data.synthetic import synthetic_batch
    from ..models.detector import GraphDETR4D
    from ..utils.device import resolve_device
    from ..weights import init_weights

    device = resolve_device(args.device)
    cfg = build_config(args)
    model = GraphDETR4D(cfg, device=device)
    if args.checkpoint:
        model.load_state_dict(load_checkpoint(args.checkpoint), strict=True)
        print(f"loaded weights from {args.checkpoint}", flush=True)
    else:  # the JAX CLI's init_state(PRNGKey(0)): seeded random weights
        init_weights(model, 0)
    model.eval()

    infos_by_token = {}
    if args.synthetic or args.ann_file is None:
        def synthetic_items():
            for i in range(args.max_samples or 4):
                b = synthetic_batch(cfg, 1, seed=100 + i)
                yield f"synthetic-{i}", b, None, None
        items = synthetic_items()
    else:
        if args.dataset == "custom6cam":
            from ..data.custom6cam import Custom6CamDataset

            ds = Custom6CamDataset(args.ann_file, max_gt=cfg.loss.max_gt,
                                   test_mode=True)
        else:
            from ..data.nuscenes import NuScenesSweepDataset

            ds = NuScenesSweepDataset(args.ann_file, test_mode=True,
                                      sweeps_num=args.sweeps_num,
                                      max_gt=cfg.loss.max_gt)
        n = min(args.max_samples or len(ds), len(ds))
        infos_by_token = {info["token"]: info for info in ds.infos
                          if isinstance(info, dict) and "token" in info}
        tta = ([float(x) for x in args.tta_resizes.split(",")]
               if args.tta_resizes else None)
        temporal = (not args.no_temporal
                    and cfg.head.num_cams > cfg.head.num_frame_cams)
        items = dataset_items(ds, cfg, n, dataset=args.dataset,
                              temporal=temporal, tta_mults=tta,
                              native_loader=args.native_loader)

    try:
        out = run_eval(model, cfg, items)
    finally:
        shutdown_decode_pool()
    metrics, results = out["metrics"], out["results"]
    print(json.dumps(metrics, indent=2), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"results": results, "metrics": metrics}, f)
    if args.format_nusc and args.dataset == "nuscenes" and infos_by_token:
        from ..eval.submission import boxes_to_nusc_annos, write_submission

        per_sample = {
            r["token"]: boxes_to_nusc_annos(
                np.asarray(r["boxes"], np.float32),
                np.asarray(r["scores"], np.float32),
                np.asarray(r["labels"], np.int32),
                infos_by_token[r["token"]])
            for r in results}
        print(f"wrote {write_submission(per_sample, args.format_nusc)}",
              flush=True)
    return out


if __name__ == "__main__":
    main()
