"""Multi-process launcher (counterpart of tools/launch_multihost.py;
reference tools/dist_train.sh and slurm_train.sh): one process per GPU,
each joining one torch.distributed process group.

    # on each of 2 hosts (or twice on one), process ids 0 and 1:
    python -m graph_detr4d_tpu_torch.tools.launch_multihost train \\
        --coordinator 10.0.0.1:29500 --num-processes 2 --process-id 0 -- \\
        --config detr4d_res50_deform_pe_testaug_2subset_12e --synthetic

    # or let torchrun start the processes and set the environment:
    torchrun --nproc-per-node 8 -m graph_detr4d_tpu_torch.tools.launch_multihost train -- ...

The JAX launcher's flags. `--coordinator host:port`, `--num-processes`
and `--process-id` become torch.distributed's environment (MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK; LOCAL_RANK 0 unless set: a process on its
own GPU); without `--coordinator` the environment torchrun set is used
as it is. Then the entry CLI (`train`, `test` or `distill_train`) runs
with the arguments after `--`; it joins the group
(parallel/mesh.py::init_distributed) and shards its batches by rank.
"""

import argparse
import os
import runpy
import sys

ENTRIES = ("train", "test", "distill_train")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="graph_detr4d_tpu_torch.tools.launch_multihost")
    p.add_argument("entry", choices=ENTRIES)
    p.add_argument("--coordinator", default=None, help="host:port")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    # not argparse.REMAINDER: that would swallow --coordinator and the
    # others when they follow the entry
    args, rest = p.parse_known_args(argv)
    args.rest = rest[1:] if rest[:1] == ["--"] else rest
    if args.coordinator and (args.num_processes is None
                             or args.process_id is None):
        p.error("--coordinator needs --num-processes and --process-id")
    return args


def distributed_env(args, environ=None) -> dict:
    """The torch.distributed environment the flags describe, over
    `environ` (default os.environ): with --coordinator, MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE and RANK from the flags, LOCAL_RANK kept or
    0; without it, environ as it is (torchrun's)."""
    env = dict(os.environ if environ is None else environ)
    if args.coordinator:
        host, port = args.coordinator.rsplit(":", 1)
        env.update(MASTER_ADDR=host, MASTER_PORT=port,
                   WORLD_SIZE=str(args.num_processes),
                   RANK=str(args.process_id))
        env.setdefault("LOCAL_RANK", "0")
    return env


def main(argv=None):
    args = parse_args(argv)
    os.environ.update(distributed_env(args))
    print(f"process {os.environ.get('RANK', 0)} of "
          f"{os.environ.get('WORLD_SIZE', 1)}: {args.entry}", flush=True)
    sys.argv = [f"graph_detr4d_tpu_torch.tools.{args.entry}", *args.rest]
    runpy.run_module(f"graph_detr4d_tpu_torch.tools.{args.entry}",
                     run_name="__main__", alter_sys=True)


if __name__ == "__main__":
    main()
