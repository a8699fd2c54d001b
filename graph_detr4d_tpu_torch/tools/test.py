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
With `--tiny`, `--cfg-options` still applies.

Several GPUs, one process each under torchrun's environment (`torchrun
--nproc-per-node N -m graph_detr4d_tpu_torch.tools.test ...` or
tools/launch_multihost.py), as the JAX CLI's multi-host eval: each data
rank clears its stale `WORK_DIR/results_rank{i}.json`, evaluates samples
rank::world and writes that file atomically; rank 0 merges them in
sample order and computes the metrics. `--cam-parallel C` lays the ranks
on a (data, cam) grid, data = world / C (`--cam-parallel N` on N ranks
is the JAX CLI's serving layout, data 1, cam N): each rank of a cam group
holds N / C cameras of the same samples, for every registry config
(models/detector.py::shard_cameras). TTA runs on one rank, as in the
JAX CLI.

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
from .train import build_config, setup_distributed


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
                   help="shard the camera axis over this many ranks (data = "
                   "world / this)")
    p.add_argument("--work-dir", default="work_dirs/detr4d",
                   help="where the ranks of a multi-rank eval write their "
                   "partial results")
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


def evaluate_samples(samples) -> dict:
    """The nuScenes metrics of the evaluator inputs run_eval collects."""
    from ..eval.nuscenes_metrics import DetectionEvaluator

    evaluator = DetectionEvaluator()
    for boxes, labels, scores, gt_boxes, gt_labels, gt_attrs, ego_xy in samples:
        evaluator.add_sample(boxes, labels, scores, gt_boxes, gt_labels,
                             gt_attrs=gt_attrs, ego_xy=ego_xy)
    return evaluator.evaluate()


def run_eval(model, cfg, items, mesh=None) -> dict:
    """items yields (token, host batch of one sample, gt_attrs or None,
    ego_xy or None). Returns {'metrics', 'results', 'samples',
    'cam_overflow', 'timing'}: samples holds each sample's evaluator
    inputs; timing holds, per sample, host_ms (producing the batch, on
    the prefetch thread), h2d_bytes, and on a CUDA device h2d_ms and
    forward_ms (CUDA events around the copies, and from there to the end
    of the forward and decode). On a `mesh` with a cam axis each batch
    keeps this rank's cameras (parallel/mesh.py::shard_batch)."""
    from ..models.detector import shard_cameras
    from ..parallel.mesh import Mesh, shard_batch
    from ..parallel.step import build_eval_step, build_tta_eval_step
    from ..parallel.transfer import batch_bytes, cast_for_transfer, to_device
    from ..train.trainer import PrefetchIterator, timed

    mesh = mesh if mesh is not None else Mesh()
    shard_cameras(model, mesh)
    device = next(model.parameters()).device
    cuda = device.type == "cuda"
    eval_step = build_eval_step(model, cfg)
    tta_step = build_tta_eval_step(model, cfg)
    samples, results, overflow = [], [], []
    timing = {"host_ms": [], "h2d_bytes": [], "h2d_ms": [], "forward_ms": []}
    pending = []

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def submit(token, batch, gt_attrs, ego_xy):
        host = _model_inputs(batch)
        if mesh.cam > 1:  # the rank's cameras (TTA stays on one rank)
            host = shard_batch(host, mesh)
        host = cast_for_transfer(host, cfg.bf16)
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
        samples.append((
            boxes, labels, scores,
            batch["gt_bboxes"][0][gkeep], batch["gt_labels"][0][gkeep],
            None if gt_attrs is None else np.asarray(gt_attrs, object)[gkeep],
            ego_xy))
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
    return {"metrics": evaluate_samples(samples), "results": results,
            "samples": samples, "cam_overflow": overflow, "timing": timing}


def dataset_items(ds, cfg, n, *, dataset="nuscenes", temporal=True,
                  tta_mults=None, native_loader=False, rank=0, world=1):
    """Samples rank, rank + world, ... of the first n of a dataset through
    build_batch (eval)."""
    from ..data.pipeline import build_batch

    for i in range(rank, n, world):
        s = ds.sample(i, temporal=temporal) if dataset == "nuscenes" \
            else ds.sample(i)
        b = build_batch(
            [s], cfg.img_size, training=False,
            img_norm=(cfg.img_mean, cfg.img_std, cfg.img_bgr),
            tta_resize_mults=tta_mults,
            device_normalize=cfg.device_normalize, use_native=native_loader)
        yield (s.get("token", f"sample-{i}"), b, s.get("gt_attrs"),
               s.get("ego_xy"))


def evaluate_dataset(model, cfg, ds, n, mesh=None, **kw) -> dict:
    """run_eval over the first n samples of ds (the train CLI's eval hook;
    every data rank evaluates them all, as the JAX CLI's hook does)."""
    return run_eval(model, cfg, dataset_items(ds, cfg, n, **kw), mesh)


def _jsonable(sample):
    return [None if v is None else np.asarray(v).tolist() for v in sample]


def _from_json(sample):
    boxes, labels, scores, gt_boxes, gt_labels, gt_attrs, ego_xy = sample
    return (np.asarray(boxes, np.float32).reshape(-1, 9),
            np.asarray(labels, np.int32), np.asarray(scores, np.float32),
            np.asarray(gt_boxes, np.float32).reshape(-1, 9),
            np.asarray(gt_labels, np.int32),
            None if gt_attrs is None else np.asarray(gt_attrs, object),
            None if ego_xy is None else np.asarray(ego_xy, np.float64))


def rank_file(work_dir: str, rank: int) -> str:
    return os.path.join(work_dir, f"results_rank{rank}.json")


def write_partial(work_dir: str, rank: int, indices, out: dict):
    """This data rank's results and evaluator inputs, written atomically
    (a poller never reads a partial file)."""
    os.makedirs(work_dir, exist_ok=True)
    path = rank_file(work_dir, rank)
    with open(path + ".tmp", "w") as f:
        json.dump({"indices": list(indices), "results": out["results"],
                   "samples": [_jsonable(s) for s in out["samples"]]}, f)
    os.replace(path + ".tmp", path)


def merge_partials(work_dir: str, world: int, timeout_s: float = 3600.0):
    """(results, evaluator inputs) of every data rank's file, in sample
    order, once all `world` files exist (rank 0 polls the shared
    filesystem, as the JAX CLI and mmcv's tmpdir collect do)."""
    import time

    want = [rank_file(work_dir, r) for r in range(world)]
    deadline = time.monotonic() + timeout_s
    while not all(os.path.exists(p) for p in want):
        if time.monotonic() > deadline:
            missing = [p for p in want if not os.path.exists(p)]
            raise TimeoutError(f"eval ranks never finished: {missing}")
        time.sleep(0.2)
    rows = []
    for p in want:
        with open(p) as f:
            part = json.load(f)
        rows += zip(part["indices"], part["results"], part["samples"])
    rows.sort(key=lambda r: r[0])
    return [r[1] for r in rows], [_from_json(r[2]) for r in rows]


def main(argv=None):
    args = parse_args(argv)
    import torch.distributed as dist

    from ..data.pipeline import shutdown_decode_pool
    from ..data.synthetic import synthetic_batch
    from ..models.detector import GraphDETR4D
    from ..weights import init_weights

    device, mesh = setup_distributed(args.device, args.cam_parallel)
    rank, world = mesh.data_index, mesh.data
    if args.tta_resizes and mesh.world > 1:
        raise SystemExit("--tta-resizes runs on one rank (the JAX CLI's "
                         "single-host TTA)")
    if world > 1:
        # drop a stale partial of an earlier run before any rank can poll
        stale = rank_file(args.work_dir, rank)
        if mesh.cam_index == 0 and os.path.exists(stale):
            os.remove(stale)
        dist.barrier()
    cfg = build_config(args)
    model = GraphDETR4D(cfg, device=device)
    if args.checkpoint:
        model.load_state_dict(load_checkpoint(args.checkpoint), strict=True)
        if mesh.is_main:
            print(f"loaded weights from {args.checkpoint}", flush=True)
    else:  # the JAX CLI's init_state(PRNGKey(0)): seeded random weights
        init_weights(model, 0)
    model.eval()

    infos_by_token = {}
    if args.synthetic or args.ann_file is None:
        n = args.max_samples or 4

        def synthetic_items():
            for i in range(rank, n, world):
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
                              native_loader=args.native_loader, rank=rank,
                              world=world)

    try:
        out = run_eval(model, cfg, items, mesh)
    finally:
        shutdown_decode_pool()
    if world > 1:
        if mesh.cam_index == 0:
            write_partial(args.work_dir, rank, range(rank, n, world), out)
        if not mesh.is_main:
            return out
        results, samples = merge_partials(args.work_dir, world)
        out.update(results=results, samples=samples,
                   metrics=evaluate_samples(samples))
    elif not mesh.is_main:  # a cam group's other ranks: rank 0 reports
        return out
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
