"""Distillation train CLI (counterpart of tools/distill_train.py; reference
tools/distill_train.py and apis/mmdet_distill_train.py:37-174).

    python -m graph_detr4d_tpu_torch.tools.distill_train \\
        --config mixdistill_r50_r18_cls_reg_2subset \\
        [--teacher-checkpoint X.pth|DIR] [--synthetic] [--steps N]

The JAX CLI's flags, with the same names and meanings, plus `--device`
(default cuda: without CUDA it raises; `--device cpu` runs on the host).
As the JAX CLI, it trains on synthetic batches made from the teacher's
config (`--ann-file` is accepted and, as there, not read), the teacher
frozen (train/distill_step.py), and saves the bare student's weights to
WORK_DIR/checkpoints in the port's checkpoint format, which tools/test.py
and tools/distill_test.py load. `--teacher-top-k`: -1 the bundle's (64),
0 all teacher rows. The port always runs the teacher as a forward of its
own, so `--split-teacher` changes nothing, and `--teacher-msda` sets a
field the port does not read (MSDA has one kernel); both are accepted.
`--data-parallel N` shards the batch over N ranks, one process a GPU
under torchrun's environment (`torchrun --nproc-per-node N -m
graph_detr4d_tpu_torch.tools.distill_train --data-parallel N ...` or
tools/launch_multihost.py), as the JAX CLI's data mesh: the global batch
(`--batch-size`, default N) must be a multiple of N, each rank makes its
share from the seed `step + rank * 100003`, and rank 0 writes the log
and the checkpoint. Teacher weights come from a port
checkpoint directory or a reference-layout `.pth`; without them, and for
the Distiller, seeded random weights (weights.init_weights).

`main(argv)` returns (DistillStep, the logged records).
"""

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="graph_detr4d_tpu_torch.tools.distill_train")
    p.add_argument("--config", default="mixdistill_r50_r18_cls_reg_2subset",
                   help="named distill config (graph_detr4d_tpu_torch.configs)")
    p.add_argument("--teacher-checkpoint", default=None,
                   help="a checkpoint directory of the port, or a "
                   "reference-layout .pth")
    p.add_argument("--work-dir", default="work_dirs/distill")
    p.add_argument("--ann-file", default=None,
                   help="accepted as by the JAX CLI, which trains on "
                   "synthetic batches only")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true", help="tiny smoke configs")
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--teacher-top-k", type=int, default=-1,
                   help="soft-GT rows: the top K teacher queries by max "
                   "score; -1 the bundle's (64), 0 all rows")
    p.add_argument("--split-teacher", action="store_true",
                   help="accepted: the port always runs the teacher as a "
                   "forward of its own")
    p.add_argument("--teacher-msda", default=None,
                   help="with --split-teacher: the teacher's msda_impl, a "
                   "TPU layout field the port does not read")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="shard the batch over this many ranks (the world "
                   "size of the process group)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.teacher_msda and not args.split_teacher:
        p.error("--teacher-msda requires --split-teacher")
    return args


def distill_config(bundle, teacher_top_k: int = -1):
    """The DistillConfig of a bundle; teacher_top_k as the flag: -1 the
    bundle's, 0 every teacher row, else that many."""
    from ..distill.distiller import DistillConfig

    return DistillConfig(
        use_instance_distill=bundle.distill_cls or bundle.distill_reg,
        cls_distill_weight=bundle.effective_cls_weight,
        reg_distill_weight=bundle.effective_reg_weight,
        use_feat_distill=bundle.distill_feat,
        feat_distill_weight=bundle.effective_feat_weight,
        feat_distill_kind=bundle.feat_mode,
        reweight_score=bundle.reweight_score,
        mix=bundle.mix,
        teacher_top_k=(bundle.teacher_top_k if teacher_top_k < 0
                       else (teacher_top_k or None)),
    )


def build_bundle(args):
    """(DistillBundle, DistillConfig) of the CLI's flags."""
    import dataclasses

    from ..config import tiny_test_config
    from ..configs import DistillBundle, get_distill_config

    if args.tiny:
        cfg = tiny_test_config()
        bundle = DistillBundle(teacher=cfg, student=cfg, mix=True)
    else:
        bundle = get_distill_config(args.config)
    if args.teacher_msda:
        t = bundle.teacher
        bundle = dataclasses.replace(bundle, teacher=dataclasses.replace(
            t, head=dataclasses.replace(t.head, msda_impl=args.teacher_msda)))
    return bundle, distill_config(bundle, args.teacher_top_k)


def main(argv=None):
    args = parse_args(argv)
    import json
    import os
    import time

    import torch

    from ..data.synthetic import synthetic_batch
    from ..distill.distiller import Distiller
    from ..models.detector import GraphDETR4D
    from ..parallel.mesh import replicate
    from ..train.checkpoint import CheckpointManager
    from ..train.distill_step import DistillStep
    from ..weights import init_weights
    from .test import load_checkpoint
    from .train import setup_distributed

    device, mesh = setup_distributed(args.device)
    dp = max(args.data_parallel, 1)
    if mesh.world != dp:
        raise SystemExit(
            f"--data-parallel {args.data_parallel} needs {dp} ranks "
            f"(torchrun --nproc-per-node {dp}, or tools/launch_multihost.py); "
            f"the process group has {mesh.world}")
    bs = args.batch_size or dp
    if bs % dp:
        raise SystemExit("--batch-size must be a multiple of --data-parallel")
    local_bs, rank = bs // dp, mesh.rank
    bundle, dcfg = build_bundle(args)
    t_cfg, s_cfg = bundle.teacher, bundle.student

    teacher = GraphDETR4D(t_cfg, device="cpu")
    if args.teacher_checkpoint:
        teacher.load_state_dict(load_checkpoint(args.teacher_checkpoint),
                                strict=True)
        if mesh.is_main:
            print(f"loaded teacher weights from {args.teacher_checkpoint}",
                  flush=True)
    else:
        init_weights(teacher, args.seed)
    dist = Distiller(s_cfg, t_cfg.neck.out_channels, device="cpu")
    init_weights(dist, args.seed + 1)
    step = DistillStep(replicate(teacher.to(device), mesh),
                       replicate(dist.to(device), mesh), s_cfg, dcfg,
                       seed=args.seed + 2, mesh=mesh)

    os.makedirs(args.work_dir, exist_ok=True)
    log_path = os.path.join(args.work_dir, "distill_log.jsonl")
    records, t0 = [], time.time()
    for i in range(args.steps):
        host = synthetic_batch(t_cfg, batch_size=local_bs,
                               seed=i + rank * 100003)
        batch = {k: torch.as_tensor(v).to(device) for k, v in host.items()}
        metrics = step.step(batch)
        if mesh.is_main and ((i + 1) % args.log_interval == 0 or i == 0):
            rec = {"step": i + 1, **{k: float(v) for k, v in metrics.items()},
                   "iter_time": (time.time() - t0) / (i + 1)}
            with open(log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(rec, flush=True)
            records.append(rec)
    # the bare student (the laterals serve distillation only,
    # mmdet_distill_train.py:88-92), loadable by tools/test.py
    if mesh.is_main:
        CheckpointManager(os.path.join(args.work_dir, "checkpoints"),
                          s_cfg).save_weights(args.steps,
                                              dist.student.state_dict())
        print(f"saved student to {args.work_dir}/checkpoints", flush=True)
    return step, records


if __name__ == "__main__":
    main()
