"""Train CLI (counterpart of tools/train.py; reference tools/train.py).

    python -m graph_detr4d_tpu_torch.tools.train \\
        --config detr4d_res50_deform_pe_testaug_2subset_12e \\
        --ann-file data/nuscenes/..._train.pkl --work-dir work_dirs/detr4d \\
        [--synthetic] [--resume] [--total-steps N] [--ckpt-every N]

The JAX CLI's flags, with the same names and meanings, plus `--device`
(default cuda: without CUDA it raises; `--device cpu` runs on the host),
`--ckpt-every` (the JAX Trainer.fit's ckpt_every, default 1000) and
`--log-interval` (its log_interval, default 50).
With `--tiny`, `--cfg-options` still applies.

Several GPUs: one process per GPU, under torchrun's environment
(`torchrun --nproc-per-node N -m graph_detr4d_tpu_torch.tools.train ...`
or tools/launch_multihost.py). As the JAX CLI: the global batch
(`--batch-size`, default the data ranks' count) is rounded up to a
multiple of the world size and each rank takes its rank-strided slice of
every global batch (`local_bs = batch / world`), the synthetic seed a
rank is `seed + rank * 100003` and the augmentation seed
`seed + 7919 * rank`; `--cam-parallel C` lays the ranks on a (data, cam)
grid (parallel/mesh.py), each rank of a cam group holding N / C cameras
of the same samples, for every registry config
(models/detector.py::shard_cameras). Rank 0 writes the log and the
checkpoints.

`main(argv)` returns the Trainer, its input threads stopped.
"""

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="graph_detr4d_tpu_torch.tools.train")
    p.add_argument("--config", default=None,
                   help="named config (graph_detr4d_tpu_torch.configs)")
    p.add_argument("--cfg-options", nargs="*", default=None,
                   help="dot-path overrides, e.g. head.num_query=600 bf16=False")
    p.add_argument("--ann-file", default=None, help="nuScenes infos pkl")
    p.add_argument("--work-dir", default="work_dirs/detr4d")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint of WORK_DIR/checkpoints")
    p.add_argument("--total-steps", type=int, default=None)
    p.add_argument("--ckpt-every", type=int, default=1000,
                   help="save a checkpoint every this many steps (and at the end)")
    p.add_argument("--log-interval", type=int, default=50,
                   help="steps per line of WORK_DIR/train_log.jsonl")
    p.add_argument("--batch-size", type=int, default=None, help="global")
    p.add_argument("--img-h", type=int, default=320)
    p.add_argument("--img-w", type=int, default=800)
    p.add_argument("--tiny", action="store_true", help="tiny debug config")
    p.add_argument("--load-interval", type=int, default=2)
    p.add_argument("--sweeps-num", type=int, default=1,
                   help="previous frames per sample (loading.py sweeps_num); "
                   "head.num_cams must equal 6*(1+sweeps_num)")
    p.add_argument("--cbgs", action="store_true",
                   help="class-balanced resampling (CBGSDataset)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--val-ann-file", default=None,
                   help="nuScenes mAP/NDS on this val pkl after every checkpoint")
    p.add_argument("--eval-samples", type=int, default=64)
    p.add_argument("--profile-steps", type=int, default=0,
                   help="torch.profiler trace of this many steps into "
                   "WORK_DIR/profile/trace.json")
    p.add_argument("--cam-parallel", type=int, default=1,
                   help="shard the camera axis over this many ranks (a 2-D "
                   "(data, cam) grid; the world size must be divisible)")
    p.add_argument("--native-loader", action="store_true",
                   help="decode and resize through the C++ loader "
                   "(graph_detr4d_tpu_torch/native); python path if it is "
                   "unavailable")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def build_config(args):
    from ..config import ModelConfig, tiny_test_config
    from ..configs import apply_overrides, get_config

    if args.tiny:
        cfg = tiny_test_config()
    elif args.config:
        return get_config(args.config, overrides=args.cfg_options)
    else:
        cfg = ModelConfig(img_size=(args.img_h, args.img_w))
    return apply_overrides(cfg, args.cfg_options) if args.cfg_options else cfg


def setup_distributed(device_arg: str, cam: int = 1):
    """(device, mesh): join torchrun's process group when its environment
    names one (parallel/mesh.py::init_distributed) and lay the ranks on a
    (data, cam) grid; one rank, unjoined, without it. The device is
    resolved first, so a CUDA device that is absent raises here."""
    from ..parallel.mesh import init_distributed, make_mesh_2d
    from ..utils.device import resolve_device

    device = init_distributed(resolve_device(device_arg))
    return device, make_mesh_2d(cam=cam)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np

    from ..data.pipeline import shutdown_decode_pool
    from ..data.synthetic import synthetic_batch
    from ..models.detector import GraphDETR4D
    from ..train.trainer import Trainer
    from ..weights import init_weights

    device, mesh = setup_distributed(args.device, args.cam_parallel)
    cfg = build_config(args)
    # each process loads its share of the global batch (the JAX CLI's
    # multi-host recipe, DistributedSampler semantics); a cam group's
    # ranks load the same samples
    rank, world = mesh.data_index, mesh.data
    batch_size = args.batch_size or world
    if batch_size % world:
        batch_size = -(-batch_size // world) * world
        if mesh.is_main:
            print(f"global batch rounded up to {batch_size} ({world} data "
                  "ranks)", flush=True)
    local_bs = batch_size // world
    total = args.total_steps or cfg.train.total_steps
    # temporal sampling iff the model's rig carries past-frame cameras
    temporal = cfg.head.num_cams > cfg.head.num_frame_cams
    img_norm = (cfg.img_mean, cfg.img_std, cfg.img_bgr)

    if args.synthetic or args.ann_file is None:
        def batches():
            seed = args.seed + rank * 100003
            while True:
                seed += 1
                yield synthetic_batch(cfg, local_bs, seed=seed)
    else:
        from ..data.nuscenes import CBGSDataset, NuScenesSweepDataset
        from ..data.pipeline import build_batch

        ds = NuScenesSweepDataset(
            args.ann_file, load_interval=args.load_interval,
            sweeps_num=args.sweeps_num, max_gt=cfg.loss.max_gt,
            seed=args.seed)
        if args.cbgs:
            ds = CBGSDataset(ds, seed=args.seed)

        def batches():
            # every rank draws the same global order and takes its
            # rank-strided slice of each global batch; augmentation draws
            # from a per-rank generator (the JAX CLI's)
            rng = np.random.RandomState(args.seed)
            aug_rng = np.random.RandomState(args.seed + 7919 * rank)
            order = rng.permutation(len(ds))
            i = 0
            while True:
                idxs = []
                for _ in range(batch_size):
                    if i >= len(order):
                        order = rng.permutation(len(ds))
                        i = 0
                    idxs.append(int(order[i]))
                    i += 1
                local = idxs[rank * local_bs:(rank + 1) * local_bs]
                samples = [ds.sample(j, temporal=temporal) for j in local]
                yield build_batch(
                    samples, cfg.img_size, training=True, rng=aug_rng,
                    aug=cfg.train, img_norm=img_norm,
                    device_normalize=cfg.device_normalize,
                    use_native=args.native_loader)

    eval_fn = None
    if args.val_ann_file:
        from .test import evaluate_dataset

        from ..data.nuscenes import NuScenesSweepDataset

        val_ds = NuScenesSweepDataset(args.val_ann_file, test_mode=True,
                                      max_gt=cfg.loss.max_gt)

        def eval_fn(model):
            m = evaluate_dataset(
                model, cfg, val_ds, min(args.eval_samples, len(val_ds)),
                mesh=mesh, temporal=temporal,
                native_loader=args.native_loader)["metrics"]
            return {"val_mAP": m["mAP"], "val_NDS": m["NDS"]}

    # seeded random weights, drawn on the host (weights.init_weights)
    init = GraphDETR4D(cfg, device="cpu")
    init_weights(init, args.seed)
    trainer = Trainer(cfg, init.state_dict(), batches(), args.work_dir,
                      device=device, seed=args.seed, eval_fn=eval_fn,
                      profile_steps=args.profile_steps, mesh=mesh)
    del init
    try:
        if args.resume:
            step = trainer.resume()
            if mesh.is_main:
                print(f"resumed at step {step}", flush=True)
        trainer.fit(total, log_interval=args.log_interval,
                    ckpt_every=args.ckpt_every)
    finally:
        trainer.close()
        shutdown_decode_pool()
    return trainer


if __name__ == "__main__":
    main()
