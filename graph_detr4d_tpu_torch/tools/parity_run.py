"""One-command real-data parity run (counterpart of tools/parity_run.py):
a reference `.pth` checkpoint -> the port's eval CLI -> mAP / NDS against
BASELINE.md's row for the config family.

    python -m graph_detr4d_tpu_torch.tools.parity_run \\
        --pth work_dirs/.../epoch_12.pth \\
        --ann-file data/nuscenes/mmdet3d_nuscenes_30f_infos_val.pkl \\
        --config detr4d_res50_deform_pe_testaug_2subset_12e \\
        [--tta-resizes 1.0,0.9,1.1] [--require-parity --tolerance 0.5]

The JAX tool converts the checkpoint to its own layout first; the port
takes the reference layout directly (tools/test.py's `--checkpoint X.pth`,
weights.load_reference_checkpoint), so there is no conversion step and no
`--num-decoder-layers` hint. The eval runs in this process. It prints ONE
JSON line (mAP and NDS in points, the baseline's, the deltas, and under
`--require-parity` the verdict) and exits non-zero iff `--require-parity`
and a gap exceeds `--tolerance` (1), or no baseline row exists under
`--require-parity` (2). `--device` defaults to cuda, as every entry point.
"""

import argparse
import json
import os
import sys

# BASELINE.md rows (reference README.md:19-21): nuScenes VAL numbers by
# config family, matched as config-name prefixes (the JAX tool's table)
BASELINES = {
    "detr4d": {"mAP": 34.2, "NDS": 44.5},  # Graph-DETR4D
    "graph_detr3d": {"mAP": 32.2, "NDS": 38.1},
    "detr3d": {"mAP": 28.9, "NDS": 34.2},
}


def baseline_for(config_name: str):
    for prefix, row in BASELINES.items():
        if config_name.startswith(prefix):
            return row
    return None


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="graph_detr4d_tpu_torch.tools.parity_run")
    p.add_argument("--pth", required=True, help="reference .pth checkpoint")
    p.add_argument("--ann-file", required=True, help="val infos pkl")
    p.add_argument("--config", default=None, help="named config")
    p.add_argument("--tiny", action="store_true", help="tiny config (tests)")
    p.add_argument("--work-dir", default="work_dirs/parity")
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--cfg-options", nargs="*", default=None)
    p.add_argument("--baseline-map", type=float, default=None)
    p.add_argument("--baseline-nds", type=float, default=None)
    p.add_argument("--tolerance", type=float, default=0.5,
                   help="allowed mAP/NDS shortfall (points) under "
                   "--require-parity")
    p.add_argument("--require-parity", action="store_true")
    p.add_argument("--tta-resizes", default=None,
                   help="comma-separated resize multipliers of test-time "
                   "augmentation (tools/test.py --tta-resizes); a *testaug* "
                   "config names that protocol")
    p.add_argument("--extra-test-args", nargs="*", default=None,
                   help="passed through to tools/test.py verbatim")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not args.tiny and not args.config:
        p.error("--config or --tiny required")
    return args


def eval_argv(args, out_json):
    """tools/test.py's arguments for this run."""
    argv = ["--ann-file", args.ann_file, "--checkpoint", args.pth,
            "--work-dir", args.work_dir, "--out", out_json,
            "--device", args.device]
    if args.tiny:
        argv.append("--tiny")
    else:
        argv += ["--config", args.config]
    if args.cfg_options:
        argv += ["--cfg-options", *args.cfg_options]
    if args.max_samples is not None:
        argv += ["--max-samples", str(args.max_samples)]
    if args.tta_resizes:
        argv += ["--tta-resizes", args.tta_resizes]
    return argv + (args.extra_test_args or [])


def verdict_of(args, cfg_name, metrics):
    """(the JSON verdict, exit code) of the metrics against the baseline
    row (or the --baseline-* values)."""
    row = baseline_for(cfg_name) or {}
    b_map = args.baseline_map if args.baseline_map is not None else row.get("mAP")
    b_nds = args.baseline_nds if args.baseline_nds is not None else row.get("NDS")
    got_map, got_nds = 100.0 * metrics["mAP"], 100.0 * metrics["NDS"]
    verdict = {
        "config": cfg_name,
        "mAP": round(got_map, 2), "NDS": round(got_nds, 2),
        "baseline_mAP": b_map, "baseline_NDS": b_nds,
        "delta_mAP": round(got_map - b_map, 2) if b_map is not None else None,
        "delta_NDS": round(got_nds - b_nds, 2) if b_nds is not None else None,
    }
    if not args.require_parity:
        return verdict, 0
    checks = [got >= base - args.tolerance
              for got, base in ((got_map, b_map), (got_nds, b_nds))
              if base is not None]
    if not checks:
        return {**verdict, "error": "no baseline row"}, 2
    verdict["parity"] = all(checks)
    return verdict, 0 if verdict["parity"] else 1


def main(argv=None):
    """Returns (verdict, exit code); prints the verdict's JSON line."""
    from . import test as test_cli

    args = parse_args(argv)
    os.makedirs(args.work_dir, exist_ok=True)
    cfg_name = "tiny" if args.tiny else args.config
    if "testaug" in cfg_name and not args.tta_resizes:
        print("[parity] WARNING: the config name says testaug but no "
              "--tta-resizes is given: evaluating single-pass, which is "
              "not the protocol the config names", flush=True)
    argv = eval_argv(args, os.path.join(args.work_dir, "parity_results.json"))
    print(f"[parity] eval: tools.test {' '.join(argv)}", flush=True)
    out = test_cli.main(argv)
    verdict, code = verdict_of(args, cfg_name, out["metrics"])
    print(json.dumps(verdict), flush=True)
    return verdict, code


if __name__ == "__main__":
    sys.exit(main()[1])
