"""A run end to end on the CPU at tiny widths, the harness's look for a
chip skipped: sound, it comes out correct; with the timed path broken
underneath, or with the float8 control in the program's place, it does
not. Without CUDA the command exits non-zero and prints no result; no
run loads JAX, and the references load nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from graph_detr4d_tpu_torch.serve import Engine
from harness.cell import load_json, run_cell
from tiny import BENCH_DIR, ROOT, TINY, bench

SEED = 2 ** 31 + 4242


def run(workload, program=None, seconds=1.0, trace=0):
    result, lines = run_cell(bench(), workload, SEED, seconds, trace, "cpu",
                             overrides=TINY, program=program)
    assert lines[-1].startswith("check ")
    assert list(result)[-1] == "checks"
    return result


@pytest.mark.parametrize("workload", ["flagship_stream", "petrv2_stream",
                                      "flagship_rig"])
def test_sound_run_is_correct(workload):
    result = run(workload)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert "setup_s" in result["metrics"] and len(result["metrics"]) == 2
    assert result["device"]["platform"] == "cpu"
    # the configuration file's overrides ran, before the tests' own
    overrides = load_json(BENCH_DIR, "configs", result["config"]["name"] + ".json"
                          ).get("overrides", [])
    assert result["config"]["overrides"] == overrides + TINY


def test_traced_run_reports_layers_and_breakdown():
    result = run("flagship_stream", trace=1)
    assert result["correct"], result["checks"]
    assert result["device"]["window_s"] > 0
    # no device on the CPU: the device-trace metrics find nothing to read
    assert "device_idle.serve" not in result["metrics"]
    assert result["metrics"]["service_ms_p95.serve"]["value"] > 0
    assert len(result["breakdown"]["idle_gaps"]) <= 10


class AlteredAnswer(Engine):
    """One served score changed after the decode."""

    @staticmethod
    def _to_host(answer):
        out = Engine._to_host(answer)
        out["scores"][0, 0] += 1e-3
        return out


class AlteredLogits(Engine):
    """The head's class logits scaled where they are produced."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.model.pts_bbox_head.register_forward_hook(
            lambda m, a, out: {**out, "all_cls_scores": out["all_cls_scores"] * 1.05})


class AlteredFeatures(Engine):
    """The neck's output scaled."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.model.img_neck.register_forward_hook(
            lambda m, a, out: [f * 1.2 for f in out])


class StaleStream(Engine):
    """A stream's cached frame left as it was after the scene's first
    request: the state returned unchanged."""

    def infer_stream(self, images, lidar2img, extras=(), stream="default"):
        kept = self._streams.get(stream)
        out = super().infer_stream(images, lidar2img, extras, stream)
        if kept is not None:
            self._streams[stream] = kept
        return out


@pytest.mark.parametrize("fault,number", [
    (AlteredAnswer, "answer"), (AlteredLogits, "logits"),
    (AlteredFeatures, "features"), (StaleStream, "features")])
def test_planted_fault_is_not_correct(fault, number, monkeypatch):
    # the feature sample among requests a CPU second surely finishes
    monkeypatch.setattr("drivers.serve.feature_sample", lambda spec, seed: {2, 5})
    result = run("flagship_stream", program=fault)
    assert not result["correct"]
    c = result["checks"][number]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("workload", ["flagship_stream", "petrv2_stream"])
def test_float8_control_is_not_correct(workload):
    from control import control_numbers

    numbers = control_numbers(bench(), workload, SEED, 8, "cpu", TINY)
    limits = load_json(BENCH_DIR, "cells", workload + ".json")["limits"]
    assert any(numbers[k] > limits[k] for k in ("features", "logits", "boxes")), numbers


def test_without_cuda_run_exits_nonzero_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload",
         "flagship_stream", "--seed", "0", "--seconds", "10", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_no_run_loads_jax_and_references_load_nothing_of_the_program():
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{ROOT!r}, {BENCH_DIR!r}, {os.path.join(BENCH_DIR, 'tests')!r}]\n"
        "import reference.flagship, reference.petrv2, flops.count\n"
        "print(json.dumps(sorted(m.split('.')[0] for m in sys.modules)))\n"
        "from harness.cell import run_cell, forbidden_modules\n"
        "from tiny import TINY, bench\n"
        "run_cell(bench(), 'flagship_stream', 5, 0.5, 0, 'cpu', overrides=TINY)\n"
        "print(json.dumps(forbidden_modules()))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    before, after = proc.stdout.strip().splitlines()[-2:]
    assert "graph_detr4d_tpu_torch" not in before and "graph_detr4d_tpu" not in before
    assert after == "[]"
    for name in os.listdir(os.path.join(BENCH_DIR, "reference")):
        if name.endswith(".py"):
            with open(os.path.join(BENCH_DIR, "reference", name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                        else [node.module or ""] if isinstance(node, ast.ImportFrom)
                        else [])
                assert not any(m.split(".")[0].startswith("graph_detr4d_tpu")
                               or m.split(".")[0] in ("jax", "flax") for m in mods)
