"""The ranks of tests/test_torch_dist.py: each runs in its own process
(parallel/mesh.py::spawn_ranks), joins a two-rank gloo group on the CPU
and runs the scenarios a pickled spec names, returning numpy values.
Imported as a top-level module (the spawned process imports it by name),
so it imports nothing of JAX or of the tests package.
"""

import os
import pickle
import threading

import numpy as np
import torch
import torch.distributed as dist

from graph_detr4d_tpu_torch.core import losses as losses_mod
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D
from graph_detr4d_tpu_torch.parallel.mesh import (init_distributed, make_mesh,
                                                  make_mesh_2d, shard_batch)
from graph_detr4d_tpu_torch.train.step import TrainStep
from graph_detr4d_tpu_torch.train.trainer import Trainer

# a collective that waits longer than this fails the rank, and the test
TIMEOUT_S = 60.0


def model_from(cfg, sd):
    model = GraphDETR4D(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    return model


def tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def params(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def replica_gap(model) -> float:
    """The largest difference of any parameter between the ranks."""
    gap = 0.0
    for p in model.parameters():
        hi, lo = p.detach().clone(), p.detach().clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        gap = max(gap, float((hi - lo).abs().max()))
    return gap


def data_steps(spec, mesh, rank):
    """Two steps of a data=2 mesh, each rank on its sample of the global
    batch of 2."""
    step = TrainStep(model_from(spec["cfg"], spec["sd"]), spec["cfg"],
                     mesh=mesh)
    local = tensors({k: v[rank:rank + 1] for k, v in spec["batch2"].items()})
    metrics = [floats(step.step(local)) for _ in range(2)]
    return {"metrics": metrics, "replica_gap": replica_gap(step.model),
            "params": params(step.model) if rank == 0 else None,
            "reduced_bytes": step.reduced_bytes}


def uneven_step(spec, mesh, rank, cfg=None):
    """One step on the planted uneven batch (every GT on rank 0)."""
    cfg = cfg or spec["cfg"]
    step = TrainStep(model_from(cfg, spec["sd"]), cfg, mesh=mesh)
    local = tensors({k: v[rank:rank + 1] for k, v in spec["uneven"].items()})
    return floats(step.step(local))


def uneven(spec, mesh, rank):
    """The synced step, and the step with each sync point left out: the
    classification avg factor's (sync_cls_avg_factor off) and the L1
    term's positive count (every second reduce_mean the loss makes, which
    is the positive count's, made the identity)."""
    import dataclasses

    out = {"synced": uneven_step(spec, mesh, rank)}
    cfg = spec["cfg"]
    no_cls = dataclasses.replace(cfg, loss=dataclasses.replace(
        cfg.loss, sync_cls_avg_factor=False))
    out["no_cls_sync"] = uneven_step(spec, mesh, rank, no_cls)
    real, calls = losses_mod.reduce_mean, [0]

    def skip_positive_count(x, group=None):
        calls[0] += 1
        return x if calls[0] % 2 == 0 else real(x, group)

    losses_mod.reduce_mean = skip_positive_count
    try:
        out["no_pos_sync"] = uneven_step(spec, mesh, rank)
    finally:
        losses_mod.reduce_mean = real
    return out


def cam_parallel(spec, mesh2, rank):
    """The eval forward and one step with the cameras split over cam=2."""
    cfg = spec["cam_cfg"]
    model = model_from(cfg, spec["cam_sd"]).eval()
    step = TrainStep(model, cfg, mesh=mesh2)  # shards the model's cameras
    batch = tensors(shard_batch(spec["batch1"], mesh2))
    with torch.no_grad():
        out = model(batch["images"], batch["lidar2img"])
    fwd = {k: out[k].numpy() for k in ("all_cls_scores", "all_bbox_preds")}
    fwd["cam_overflow"] = float(out["cam_overflow"])
    metrics = floats(step.step(batch))
    return {"forward": fwd, "metrics": metrics,
            "cameras": int(batch["images"].shape[1]),
            "replica_gap": replica_gap(step.model),
            "params": params(step.model) if rank == 0 else None}


def cam_variants(spec, mesh2):
    """Eval forwards at cam=2 of the other heads camera parallelism serves
    (the camera-aware head with the camconv gate and scale_pred, H-DETR,
    MP, DETR3D, DETR3D-v2, PETR, PETRv2, PETR-seg): every decoder output,
    and the decode of the heads spec["decode"] names."""
    from graph_detr4d_tpu_torch.models.detector import (model_extras,
                                                        shard_cameras)
    from graph_detr4d_tpu_torch.parallel.step import build_eval_step

    out = {}
    heads = {**spec["cam_variants"], **spec["cam_heads"]}
    for name, (cfg, sd, batch) in heads.items():
        model = shard_cameras(model_from(cfg, sd).eval(), mesh2)
        b = tensors(shard_batch(batch, mesh2))
        with torch.no_grad():
            o = model(b["images"], b["lidar2img"], **model_extras(b))
        out[name] = {k: v.numpy() for k, v in o.items()
                     if k.startswith("all_")}
        if name in spec["decode"]:
            det, _ = build_eval_step(model, cfg)(b)
            out[name]["decode"] = {k: v.numpy()
                                   for k, v in det._asdict().items()}
    return out


def cam_steps(spec, mesh2):
    """One train step at cam=2 (dropout on) of each config in
    spec["cam_steps"]: its metrics."""
    out = {}
    for name, (cfg, sd, batch) in spec["cam_steps"].items():
        step = TrainStep(model_from(cfg, sd), cfg, mesh=mesh2)
        out[name] = floats(step.step(tensors(shard_batch(batch, mesh2))))
    return out


def eval_cli(spec, rank):
    from graph_detr4d_tpu_torch.tools import test as test_cli_mod

    out = test_cli_mod.main(spec["test_argv"])
    keep = ("metrics", "results") if rank == 0 else ()
    return {k: out[k] for k in keep}


def fit(spec, mesh, work_dir, upto, resume=False, start=0):
    batches = spec["train_batches"]
    trainer = Trainer(spec["train_cfg"], {k: torch.from_numpy(v) for k, v in
                                          spec["sd"].items()},
                      iter([b[mesh.rank] for b in batches[start:]]),
                      work_dir, device="cpu", seed=5, mesh=mesh)
    try:
        if resume:
            trainer.resume()
        trainer.fit(upto, log_interval=1, ckpt_every=2)
    finally:
        trainer.close()
    alive = any(t.name.startswith("trainer-") for t in threading.enumerate())
    return params(trainer.model), trainer.step, alive


def resume(spec, mesh, rank):
    """A Trainer run to step 3, and one saved at 2 then resumed to 3 (grid
    mask and dropout on: each data rank's generator must come back)."""
    root = spec["work_dir"]
    whole, _, alive1 = fit(spec, mesh, os.path.join(root, "whole"), 3)
    part = os.path.join(root, "part")
    fit(spec, mesh, part, 2)
    resumed, step, alive2 = fit(spec, mesh, part, 3, resume=True, start=2)
    gap = max(float(np.abs(whole[n] - resumed[n]).max()) for n in whole)
    dist.barrier()  # rank 0's log is complete
    with open(os.path.join(root, "whole", "train_log.jsonl")) as f:
        log_lines = len(f.readlines())
    return {"gap": gap, "step": step, "threads_alive": alive1 or alive2,
            "log_lines": log_lines}


def run(rank, world, spec_path):
    torch.set_num_threads(2)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    init_distributed("cpu", timeout_s=TIMEOUT_S)
    mesh = make_mesh()
    mesh2 = make_mesh_2d(cam=2)
    return {"data": data_steps(spec, mesh, rank),
            "uneven": uneven(spec, mesh, rank),
            "cam": cam_parallel(spec, mesh2, rank),
            "cam_variants": cam_variants(spec, mesh2),
            "cam_steps": cam_steps(spec, mesh2),
            "test_cli": eval_cli(spec, rank),
            "resume": resume(spec, mesh, rank)}
