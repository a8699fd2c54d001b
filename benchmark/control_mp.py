"""benchmark/control.py for the MP cells: the reference in float8 in the
program's place, its `logits` and `boxes` made as drivers/serve_mp.py
makes them, the float8 reference's own first-layer graph in the
program's place.

    python3 benchmark/control_mp.py --workload NAME --seeds N [N ...] [--requests 40]

prints, for each seed, one JSON line of the numbers a run's check would
compare had the float8 reference served the requests: control.py's
`features`, and `logits` and `boxes` as drivers/serve_mp.py makes them
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

    from control import control_numbers as plain_numbers
    from drivers.serve import check_sample
    from drivers.serve_mp import KeptReferenceRun, first_graph, head_numbers
    from harness.cell import BENCH_DIR as BD, load_json, resolve_config
    from harness.traffic import Traffic
    from harness.weights import make_state_dict
    from reference import load
    from reference.common import strict_float32

    numbers = plain_numbers(bench, workload, seed, requests, device, overrides)
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    config = load_json(BD, "configs", cell["config"] + ".json")
    spec = load_json(BD, "traffic", cell["traffic"] + ".json")
    _, model = resolve_config(config, overrides)
    ref_mod = load(config["reference"])
    sd = make_state_dict(ref_mod.param_specs(model), seed % 2 ** 64, device)
    traffic = Traffic(spec, model, config.get("extras", {}), seed, device)
    picks = check_sample(spec, traffic.entry, requests, seed)
    strict_float32()
    low = KeptReferenceRun(ref_mod, model, sd, traffic, "fp8")
    ref = KeptReferenceRun(ref_mod, model, sd, traffic)
    with torch.no_grad():
        for i in picks:
            low.request(i)
            ref.request(i)
        graph = first_graph(ref_mod, model, low.ref)[1]
        numbers.update(head_numbers(low.kept, {i: graph for i in picks}, ref.kept,
                                    *first_graph(ref_mod, model, ref.ref)))
    return numbers


def main(argv=None):
    p = argparse.ArgumentParser(prog="benchmark/control_mp.py")
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
