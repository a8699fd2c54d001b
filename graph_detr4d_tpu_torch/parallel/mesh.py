"""Process groups for data and camera parallelism over torch.distributed
(counterpart of graph_detr4d_tpu/parallel/mesh.py; reference
tools/dist_train.sh + MMDistributedDataParallel, one process per GPU).

    device = init_distributed("cuda")     # torchrun's environment
    mesh = make_mesh()                    # 1-D: every rank a data shard
    mesh = make_mesh_2d(cam=2)            # (data, cam): rank = d * cam + c
    batch = shard_batch(local_batch, mesh)
    replicate(model, mesh)

The JAX package lays a jax Mesh over the devices and lets GSPMD insert
the collectives; here they are explicit:
  * the loss's two `reduce_mean` sync points (core/losses.py) are an
    all-reduce over the `data` group divided by its size;
  * every gradient is averaged over all ranks in one coalesced all-reduce
    (train/step.py), before the clip, so the clip sees the global norm;
  * on a `cam` group each rank holds N / cam of the cameras: the conv stack
    and K1's sampling run on them, and every camera sum of a head is an
    all-reduce over the group whose backward also sums (`all_reduce_sum`:
    the gated sums of models/attention.py and attention_variants.py, the
    dense attention's softmax numerator and denominator of
    models/transformer.py, whose stabilising row max is `all_reduce_max`).
The JAX package's `constrain` (a GSPMD sharding annotation) has no
counterpart: torch has no such annotation, and the model reads the
camera slice it holds from the attention's `cam_shard`.

Each process loads its own share of the global batch (the JAX CLIs'
multi-host recipe), so `shard_batch` only keeps this rank's cameras.
`spawn_ranks` starts local ranks, each joined with a timeout, for tests
and the card's smoke script.
"""

import datetime
import os
import socket
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

# batch keys whose second axis is the camera axis (B, N, ...). The PETR
# heads' optional img_valid_hw (B, N, 2) is not one: their padding mask
# encodes its camera axis over the whole rig, so a shard reads the whole
# rig's value (models/petr_head.py::PETRHead.memory)
_CAM_KEYS = ("images", "lidar2img", "intrinsics", "ida_scale", "depth_factors")


def init_distributed(device="cuda", backend: Optional[str] = None,
                     timeout_s: float = 1800.0) -> torch.device:
    """Join the process group torchrun's environment describes (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return this
    rank's device: cuda:LOCAL_RANK for a CUDA device. Backend NCCL on CUDA
    and gloo on the CPU unless `backend` names one. Without WORLD_SIZE, or
    with a group already joined, it joins nothing."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method="env://",
        world_size=int(os.environ["WORLD_SIZE"]),
        rank=int(os.environ["RANK"]),
        timeout=datetime.timedelta(seconds=timeout_s),
        **({"device_id": dev} if backend == "nccl" else {}))
    return dev


@dataclass(frozen=True)
class Mesh:
    """This rank's place on a (data, cam) grid of world = data * cam
    ranks (rank = data_index * cam + cam_index, the JAX grid's order) and
    the groups it belongs to: `data_group` (the ranks holding the same
    cameras; the whole world on a 1-D mesh), `cam_group` (the ranks
    sharing one batch shard; None when cam is 1). Without a process group
    both are None and the mesh is one rank."""

    data: int = 1
    cam: int = 1
    rank: int = 0
    data_group: Optional[object] = None
    cam_group: Optional[object] = None

    @property
    def world(self) -> int:
        return self.data * self.cam

    @property
    def data_index(self) -> int:
        return self.rank // self.cam

    @property
    def cam_index(self) -> int:
        return self.rank % self.cam

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def distributed(self) -> bool:
        return self.data_group is not None


def make_mesh() -> Mesh:
    """The 1-D data mesh over every rank of the process group (one rank
    without a group)."""
    return make_mesh_2d(cam=1)


def make_mesh_2d(cam: int = 1) -> Mesh:
    """The (data, cam) mesh: the world size must be divisible by `cam`.
    Every rank creates every group, in the same order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % cam:
        raise ValueError(f"{world} ranks not divisible by cam={cam}")
    if not dist.is_initialized():
        return Mesh()
    rank, data = dist.get_rank(), world // cam
    if cam == 1:
        return Mesh(data, 1, rank, dist.group.WORLD, None)
    d, c = rank // cam, rank % cam
    data_group = cam_group = None
    for ci in range(cam):
        g = dist.new_group([di * cam + ci for di in range(data)])
        data_group = g if ci == c else data_group
    for di in range(data):
        g = dist.new_group([di * cam + ci for ci in range(cam)])
        cam_group = g if di == d else cam_group
    return Mesh(data, cam, rank, data_group, cam_group)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's camera slice of the _CAM_KEYS entries with a camera
    axis ((B, N, ...), N divisible by mesh.cam); every other entry, and
    every entry on a mesh without a cam axis, unchanged. The batch is this
    rank's data shard already. Refuses a TTA image stack (ndim 6), as the
    JAX function does: TTA is a single-rank path."""
    images = batch.get("images")
    if images is not None and images.ndim == 6:
        raise ValueError(
            "shard_batch cannot shard a TTA image stack (ndim 6); run "
            "--tta-resizes on one rank")
    if mesh.cam == 1:
        return batch
    out = dict(batch)
    for k in _CAM_KEYS:
        v = batch.get(k)
        if v is None or v.ndim < 2:
            continue
        n = v.shape[1]
        if n % mesh.cam:
            raise ValueError(f"{k}: {n} cameras not divisible by "
                             f"cam={mesh.cam}")
        m = n // mesh.cam
        out[k] = v[:, mesh.cam_index * m:(mesh.cam_index + 1) * m]
    return out


def replicate(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank."""
    if mesh.distributed:
        with torch.no_grad():
            for t in [*model.parameters(), *model.buffers()]:
                dist.broadcast(t.data, src=0)
    return model


def reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of x over `group` (all_reduce SUM / size), with no
    gradient: the reference's reduce_mean, the JAX package's lax.pmean.
    The identity without a group."""
    if group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y / dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group`, whose backward also sums the incoming
    gradients over the group. Each rank of a cam group holds a partial
    camera sum and the same loss, so rank r's parameter gradient is
    replicated + cam * local_r; averaged over the group (train/step.py)
    it is replicated + sum_r local_r, the one-process gradient."""
    return _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of x over `group`, detached: a value that needs
    no gradient (the row max that stabilises a softmax split over ranks,
    whose result does not depend on it)."""
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def all_reduce_mean_(tensors, group=None) -> int:
    """Average `tensors` in place over `group` (default: every rank) in
    one all-reduce per dtype of a flattened buffer. Returns the bytes
    reduced."""
    size = dist.get_world_size(group)
    nbytes = 0
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat /= size
        nbytes += flat.numel() * flat.element_size()
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return nbytes


def gather_states(state: torch.Tensor, mesh: Mesh, device) -> list:
    """Every data rank's copy of a 1-D uint8 `state` (a generator's), in
    data-rank order, as CPU tensors: one all-reduce on `device` over the
    data group (gloo reduces CUDA tensors only by broadcast and
    all-reduce; NCCL reduces only CUDA tensors)."""
    if mesh.data_group is None or mesh.data == 1:
        return [state]
    buf = torch.zeros(mesh.data, state.numel(), dtype=torch.int32,
                      device=device)
    buf[mesh.data_index] = state.to(device, torch.int32)
    dist.all_reduce(buf, group=mesh.data_group)
    return [row.to("cpu", torch.uint8) for row in buf.cpu()]


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, results, args):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK="0")
    try:
        out = fn(rank, world, *args)
        results.put((rank, "ok", out))
    except BaseException as e:  # the parent raises it
        import traceback

        results.put((rank, "error", f"{type(e).__name__}: {e}\n"
                     + traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world: int, *args, timeout_s: float = 120.0) -> list:
    """Run fn(rank, world, *args) in `world` new processes (start method
    spawn) with torchrun's environment on a free localhost port, each
    process's LOCAL_RANK 0; fn joins the group itself (init_distributed).
    Returns the ranks' results in rank order. A rank that raises, exits
    or is not done within timeout_s fails the call, and every process is
    stopped before it returns or raises."""
    import queue
    import time

    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, results, args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world)) - set(out))} not done "
                    f"in {timeout_s} s")
            try:
                rank, status, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited without a "
                                       "result")
                continue
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed: {value}")
            out[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5.0)
    return [out[r] for r in range(world)]
