"""benchmark/control.py for the BEVFormer cell: the reference in float8
in the program's place, its numbers made as drivers/serve_bev.py makes
them.

    python3 benchmark/control_bev.py --workload NAME --seeds N [N ...] [--requests 80]

For each seed it makes the run's weights and traffic, draws the check's
samples among the first --requests requests as a run does, runs the
float8 reference through those requests as the program would have served
them (each request's previous BEV its own of the request before) and
prints one JSON line of the numbers the check would compare
(`overflow` and `answer` do not apply). The benchmark's runs do not run
this; the limits in cells/<workload>.json were set from its readings and
the program's (PERF.md).
"""

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def control_numbers(bench, workload, seed, requests, device, overrides=()):
    """The check's numbers with the float8 reference as the program;
    `overrides` after the configuration file's own (the tests' tiny
    widths)."""
    import torch

    import reference
    from drivers.serve_bev import (BEVReference, BEVTraffic, bev_kept,
                                   check_sample, compare, feature_sample)
    from harness.cell import BENCH_DIR as BD, load_json, resolve_config
    from harness.weights import make_state_dict
    from reference.common import strict_float32

    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    config = load_json(BD, "configs", cell["config"] + ".json")
    spec = load_json(BD, "traffic", cell["traffic"] + ".json")
    _, model = resolve_config(config, overrides)
    ref_mod = reference.load(config["reference"])
    sd = make_state_dict(ref_mod.param_specs(model), seed % 2 ** 64, device)
    traffic = BEVTraffic(spec, model, seed, device)
    picks = [i for i in check_sample(spec, seed) if i < requests]
    feats = {i for i in feature_sample(spec, seed) if i < requests}
    keep = bev_kept(spec, picks)
    strict_float32()
    low = BEVReference(ref_mod, model, sd, traffic, "fp8")
    program = {"overflow": 0.0, "features": {}, "heads": {}, "answers": {},
               "bevs": {}}
    with torch.no_grad():
        bev = None
        for i in range(max(keep | feats) + 1):
            bev, cls, box = low.request(i, None if traffic.starts_scene(i) else bev)
            if i in keep:
                program["bevs"][i] = bev
            if i in picks:
                program["heads"][i] = (cls, box)
            if i in feats:
                program["features"][i] = low.feats(i)
        ref = BEVReference(ref_mod, model, sd, traffic)
        return compare(program, ref, picks, spec["chain_frames"] - 1,
                       model["coder"], answers=False)


def main(argv=None):
    p = argparse.ArgumentParser(prog="benchmark/control_bev.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--requests", type=int, default=80)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the control runs at the cell's size on a CUDA device", file=sys.stderr)
        return 3
    sys.path[:0] = [ROOT, BENCH_DIR]
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for seed in args.seeds:
        numbers = control_numbers(bench, args.workload, seed, args.requests, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": "fp8", **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
