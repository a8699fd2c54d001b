"""One run of one cell: set-up, the measured window, the traced window,
the check against the reference, the result line.

Everything that belongs to a configuration, a traffic mix or a per-layer
metric is read from its own file, found by the names in BENCHMARK.json:
`configs/<config>.json` (the configuration as it is run: the program's
registry entry, the `overrides` applied to it and the resulting `model`,
its reference module under `reference/`, its extra inputs),
`traffic/<traffic>.json` (a traffic mix's parameters, and the `driver`
under `drivers/` that reads them), `cells/<workload>.json` (the FLOPs of
one request and the limits of the comparison) and `metrics/<metric>.py`
(a per-layer metric's reader).

A driver (`drivers/<driver>.py`) is the code of one kind of traffic:

  setup(run)           weights and inputs from run.seed, the system under
                       test; sets run.model, the module the metrics hook
  warm(run)            every shape the window will use
  send(run, i)         unit of work i (a request), done on the host when
                       it returns
  window(run, seconds) the measured window (`closed_loop` below), the
                       check's capture around it; returns the end-to-end
                       values by metric name
  check(run)           after the window: the program's state freed, the
                       numbers compared with the cell's limits
"""

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

from harness.trace import WINDOW, Trace

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# packages that the port must not load in a run (compared by the whole
# top-level name: the port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "graph_detr4d_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def plain(x):
    """Tuples as lists, as JSON holds a dataclass's fields."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def load_metric(name: str):
    """The module `metrics/<name>.py` (a metric's name holds dots)."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve_config(config: dict, extra=()):
    """(the program's config, its dict) for a configuration file: the
    registry entry `port_config` with the file's `overrides`, then
    `extra` (the tests' tiny widths). Without `extra` the result has to be
    the file's `model`, so the file states what runs."""
    from graph_detr4d_tpu_torch.configs import get_config

    cfg = get_config(config["port_config"],
                     list(config.get("overrides", [])) + list(extra))
    model = plain(dataclasses.asdict(cfg))
    if not extra and model != config["model"]:
        raise RuntimeError(f"{config['port_config']} with {config.get('overrides', [])} "
                           f"is not configs/{config['name']}.json's model")
    return cfg, model


def percentile(values, q):
    """The q-th percentile by linear interpolation between order
    statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values), q))


class Run:
    """The state of one run that the driver and the per-layer metrics
    read: the configuration (`cfg`, `model_dict`), the traffic's
    parameters, the cell's file, the driver's `model`, the measured
    window (`requests`, `window_s`, `service` each request's seconds and
    `service_s` their sum), the traced windows' `trace` and
    `traced_requests`, and `cleanups` to undo what a metric installed.
    `program` stands in for the system under test (a test's planted
    fault)."""

    def __init__(self, bench, workload, seed, device, overrides=(), program=None):
        cell = next(w for w in bench["workloads"] if w["name"] == workload)
        self.cell_spec = cell
        self.seed = seed
        self.config = load_json(BENCH_DIR, "configs", cell["config"] + ".json")
        self.traffic_spec = load_json(BENCH_DIR, "traffic", cell["traffic"] + ".json")
        self.cell = load_json(BENCH_DIR, "cells", workload + ".json")
        self.driver = importlib.import_module("drivers." + self.traffic_spec["driver"])
        self.device = torch.device(device)
        self.program = program
        self.cfg, self.model_dict = resolve_config(self.config, overrides)
        self.model = None
        self.cleanups = []
        self.state = {}
        self.requests = 0
        self.window_s = 0.0
        self.service, self.service_s = [], 0.0
        self.trace = None
        self.traced_requests = 0

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def traced_window(self, metrics):
        """The per-layer metrics' windows, after the measured one, each of
        `trace_requests` units sent back to back: first with the
        instruments that need no profiler (CUDA events: the profiler's
        overhead would stretch launch-bound spans), then under the
        profiler with the others; then the trace is read."""
        from torch.profiler import ProfilerActivity, profile, record_function

        n = self.traffic_spec["trace_requests"]
        for profiled in (False, True):
            for m in metrics.values():
                if hasattr(m, "install") and getattr(m, "PROFILED", True) == profiled:
                    m.install(self)
            self.sync()
            first = self.requests + (n if profiled else 0)
            if profiled:
                activities = [ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    activities.append(ProfilerActivity.CUDA)
                with profile(activities=activities) as prof:
                    with record_function(WINDOW):
                        for k in range(n):
                            self.driver.send(self, first + k)
                        self.sync()
            else:
                for k in range(n):
                    self.driver.send(self, first + k)
                self.sync()
            while self.cleanups:
                self.cleanups.pop()()
        self.traced_requests = n
        self.trace = Trace(prof)


def closed_loop(run, seconds):
    """The measured window of one client sending back to back: unit i is
    sent as soon as unit i - 1 is done, while the window lasts; the
    window ends when the last unit sent is done, and holds all of its
    time."""
    service = []
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        ts = time.perf_counter()
        run.driver.send(run, i)
        service.append(time.perf_counter() - ts)
        i += 1
    run.window_s = time.perf_counter() - t0
    run.requests = i
    run.service = service
    run.service_s = sum(service)


def window_summary(run):
    """The window for a reader of standard error: the units done a second
    in each third of it and the median unit's time."""
    service = run.service
    n = len(service)
    thirds = [service[k * n // 3:(k + 1) * n // 3] for k in range(3)]
    rates = " ".join(f"{len(t) / sum(t):.3f}" for t in thirds if t)
    return (f"window: {n} requests in {run.window_s:.2f} s, done a second by "
            f"thirds {rates}, median {1e3 * percentile(service, 50):.2f} ms")


def device_info(device, count):
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": count,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": 0}


def run_cell(bench, workload, seed, seconds, trace, device="cuda", t_start=None,
             overrides=(), program=None):
    """One run; returns (result dict, the lines for standard error).
    `overrides`: config overrides after the file's own (the tests' tiny
    widths); `program` stands in for the system under test."""
    t_start = time.perf_counter() if t_start is None else t_start
    run = Run(bench, workload, seed, device, overrides, program)
    driver = run.driver
    driver.setup(run)
    driver.warm(run)
    setup_s = time.perf_counter() - t_start
    values = driver.window(run, seconds)
    run.sync()
    values["setup_s"] = setup_s
    dev = device_info(run.device, run.cell_spec["chips"])
    result = {"correct": False, "attempted": run.requests, "failed": 0}
    end_to_end = {m["name"]: m for m in bench["end_to_end"]}
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    reported = {n for n, m in end_to_end.items()
                if workload in m.get("workloads", [workload])}
    metrics = {}
    if trace:
        names = [n for n, m in per_layer.items()
                 if workload in m.get("workloads", [workload])
                 and m["moves"] in reported]
        readers = {n: load_metric(n) for n in names}
        run.traced_window(readers)
        for n, r in readers.items():
            v = r.read(run)
            if v is not None:
                metrics[n] = {"value": v, "unit": per_layer[n]["unit"]}
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    else:
        for n in sorted(reported):
            metrics[n] = {"value": values[n], "unit": end_to_end[n]["unit"]}
    result["metrics"] = metrics
    result["device"] = dev
    result["config"] = {"name": run.config["name"],
                        "port_config": run.config["port_config"],
                        "overrides": list(run.config.get("overrides", [])) + list(overrides)}

    t_ref = time.perf_counter()
    numbers = driver.check(run)
    numbers_s = time.perf_counter() - t_ref
    limits = run.cell["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {', '.join(found)}")
    result["checks"] = checks
    lines = [window_summary(run),
             f"config {result['config']['name']}: {result['config']['port_config']}"
             f" with {result['config']['overrides']}",
             f"check took {numbers_s:.1f} s"]
    lines += [f"check {k} {c['value']!r} limit {c['limit']!r}"
              for k, c in checks.items()]
    return result, lines
