"""BENCHMARK.json resolves to the benchmark's files, by name, and holds
only what the benchmark's contract allows."""

import dataclasses
import math
import os
import re

import pytest

import reference
from graph_detr4d_tpu_torch.configs import get_config
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D
from harness.cell import load_json, plain
from tiny import BENCH_DIR, ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = bench()


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["traffic"] for w in SPEC["workloads"]]
    for n in names:
        assert NAME.match(n), n
    assert len(set(c["name"] for c in SPEC["configs"])) == len(SPEC["configs"])
    metric_names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in SPEC["workloads"]]
                 + [m["layer"] for m in SPEC["per_layer"]]
                 + [c["source"] for c in SPEC["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_workload_resolves_to_its_files(workload):
    cell = next(w for w in SPEC["workloads"] if w["name"] == workload)
    assert cell["chips"] == 1
    config = load_json(BENCH_DIR, "configs", cell["config"] + ".json")
    assert reference.load(config["reference"]).param_specs
    traffic = load_json(BENCH_DIR, "traffic", cell["traffic"] + ".json")
    assert os.path.exists(os.path.join(BENCH_DIR, "drivers", traffic["driver"] + ".py"))
    limits = load_json(BENCH_DIR, "cells", workload + ".json")["limits"]
    assert set(limits) == {"overflow", "answer", "features", "logits", "boxes"}
    reported = [m for m in SPEC["end_to_end"]
                if workload in m.get("workloads", [workload])]
    assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
    layer = [m for m in SPEC["per_layer"]
             if workload in m.get("workloads", [workload])]
    assert layer
    for m in layer:
        assert m["moves"] in [r["name"] for r in reported]
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics", m["name"] + ".py"))


def test_bounds_and_sources():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert "bound" not in m


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_file_is_the_program_config_and_loads_strict(name):
    entry = next(c for c in SPEC["configs"] if c["name"] == name)
    config = load_json(ROOT, entry["file"])
    assert entry["reduced"] == config["reduced"] == []
    cfg = get_config(config["port_config"], config.get("overrides", []))
    assert plain(dataclasses.asdict(cfg)) == config["model"]
    specs = reference.load(config["reference"]).param_specs(config["model"])
    want = {n: tuple(shape) for n, shape, _ in specs}
    got = {n: tuple(t.shape) for n, t in
           GraphDETR4D(cfg, device="cpu").state_dict().items()}
    assert want == got


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_flops_are_the_reference_count(workload):
    from flops.count import request_flops

    cell = next(w for w in SPEC["workloads"] if w["name"] == workload)
    config = load_json(BENCH_DIR, "configs", cell["config"] + ".json")
    entry = load_json(BENCH_DIR, "traffic", cell["traffic"] + ".json")["entry"]
    flops = load_json(BENCH_DIR, "cells", workload + ".json")["flops_per_request"]
    assert request_flops(config, entry) == flops
    assert math.isfinite(flops) and flops > 0


def test_petrv2_runs_the_published_decoder_width():
    # petrv2_vovnet_gridmask_p4_1600x640.py: feedforward_channels=2048,
    # where the program's registry entry keeps HeadConfig's 512
    config = load_json(BENCH_DIR, "configs", "petrv2.json")
    assert config["model"]["head"]["ffn_dims"] == 2048
    assert get_config(config["port_config"]).head.ffn_dims == 512
    assert config["overrides"] == ["head.ffn_dims=2048"]
