"""Distillation eval CLI (counterpart of tools/distill_test.py; reference
tools/distill_test.py: load the distiller, test the student).

    python -m graph_detr4d_tpu_torch.tools.distill_test \\
        --config mixdistill_r50_r18_cls_reg_2subset \\
        --checkpoint work_dirs/distill/checkpoints [--synthetic]

Builds the bundle's student (with `--tiny`, the tiny config), loads the
checkpoint distill_train saved (a port checkpoint directory, or a
reference-layout `.pth`; without one, seeded random weights, as the JAX
CLI's init) and evaluates it through parallel/step.py::build_eval_step
(tools/test.py::run_eval) on `--max-samples` synthetic samples from the
student's config, as the JAX CLI (which also accepts `--ann-file` and
`--synthetic` and reads neither; tools/test.py evaluates a dataset).
Prints the metrics. The JAX CLI's flags plus `--device` (default cuda:
without CUDA it raises; `--device cpu` runs on the host).

`main(argv)` returns tools/test.py::run_eval's dict.
"""

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="graph_detr4d_tpu_torch.tools.distill_test")
    p.add_argument("--config", default="mixdistill_r50_r18_cls_reg_2subset")
    p.add_argument("--checkpoint", default=None,
                   help="a checkpoint directory of the port, or a "
                   "reference-layout .pth")
    p.add_argument("--ann-file", default=None,
                   help="accepted as by the JAX CLI, which evaluates "
                   "synthetic samples only")
    p.add_argument("--max-samples", type=int, default=32)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..config import tiny_test_config
    from ..configs import get_distill_config
    from ..data.synthetic import synthetic_batch
    from ..models.detector import GraphDETR4D
    from ..utils.device import resolve_device
    from ..weights import init_weights
    from .test import load_checkpoint, run_eval

    device = resolve_device(args.device)
    cfg = (tiny_test_config() if args.tiny
           else get_distill_config(args.config).student)
    model = GraphDETR4D(cfg, device=device)
    if args.checkpoint:
        model.load_state_dict(load_checkpoint(args.checkpoint), strict=True)
        print(f"loaded student weights from {args.checkpoint}", flush=True)
    else:
        init_weights(model, 0)
    model.eval()

    items = ((f"synthetic-{i}", synthetic_batch(cfg, 1, seed=1000 + i),
              None, None) for i in range(args.max_samples))
    out = run_eval(model, cfg, items)
    print({k: round(float(v), 4) for k, v in out["metrics"].items()
           if not isinstance(v, dict)}, flush=True)
    return out


if __name__ == "__main__":
    main()
