"""The comparison's control: the reference in the program's place,
computed in float8 (e4m3, per-tensor scales on both operands of every
product), the step below the configurations' bfloat16.

    python3 benchmark/control.py --workload NAME --seeds N [N ...] [--requests 40]

For each seed it makes the run's weights and traffic, draws the check's
sample among the first --requests requests as a run does, and prints one
JSON line of the numbers the check would compare if the float8 reference
had served them (`overflow` and `answer` do not apply: the reference
compacts nothing and its answer is its own decode). The benchmark's runs
do not run this; the limits in cells/<workload>.json were set from its
readings and the program's (PERF.md).
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
    from drivers.serve import check_sample, feature_sample
    from harness import check
    from harness.cell import BENCH_DIR as BD, load_json, resolve_config
    from harness.traffic import Traffic
    from harness.weights import make_state_dict
    from reference.common import strict_float32

    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    config = load_json(BD, "configs", cell["config"] + ".json")
    spec = load_json(BD, "traffic", cell["traffic"] + ".json")
    _, model = resolve_config(config, overrides)
    ref_mod = reference.load(config["reference"])
    sd = make_state_dict(ref_mod.param_specs(model), seed % 2 ** 64, device)
    traffic = Traffic(spec, model, config.get("extras", {}), seed, device)
    feats = {i for i in feature_sample(spec, seed) if i < requests}
    picks = check_sample(spec, traffic.entry, requests, seed)
    strict_float32()
    low = check.ReferenceRun(ref_mod, model, sd, traffic, "fp8")
    with torch.no_grad():
        program = {"overflow": 0.0, "answers": {}, "heads": {}, "features": {}}
        for i in sorted(set(picks) | feats):
            f, cls, box = low.request(i)
            if i in picks:
                program["heads"][i] = (cls, box)
            if i in feats:
                program["features"][i] = f
        ref = check.ReferenceRun(ref_mod, model, sd, traffic)
        numbers = check.compare(program, ref, model["coder"], answers=False)
    return numbers


def main(argv=None):
    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--requests", type=int, default=40)
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
