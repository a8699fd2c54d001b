"""The distillation registry and CLIs of the port on the CPU.

* every distill bundle of the JAX registry (configs.get_distill_config:
  the teacher and student configs with the distill pin, the switches,
  the weights and their effective values, teacher_top_k) equal to the
  port's, field for field, one case a bundle;
* distill_train --tiny --device cpu --steps 2, then distill_test and the
  test CLI on the student checkpoint it saved (the seam of
  tests/test_tools.py::test_cli_chain_distill_train_to_distill_test), and
  a second distill run taking that checkpoint as its teacher;
* --teacher-top-k's meanings (-1 the bundle's 64, 0 all rows),
  --teacher-msda needing --split-teacher;
* --data-parallel 2 in one process exits (it needs a process group of 2
  ranks); without CUDA and without --device cpu, both CLIs raise.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import graph_detr4d_tpu.configs as jax_configs  # noqa: E402
import graph_detr4d_tpu_torch.configs as port_configs  # noqa: E402
from graph_detr4d_tpu_torch.tools import distill_test, distill_train  # noqa: E402
from graph_detr4d_tpu_torch.tools import test as test_cli  # noqa: E402
from graph_detr4d_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several test processes at
    once, and tiny steps gain nothing from more."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_the_port_registers_every_bundle_of_the_jax_registry():
    assert port_configs.list_distill_configs() == \
        jax_configs.list_distill_configs()
    assert len(port_configs.list_distill_configs()) == 18


@pytest.mark.parametrize("name", jax_configs.list_distill_configs())
def test_distill_bundle_equals_jax(name):
    got = port_configs.get_distill_config(name)
    want = jax_configs.get_distill_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("effective_cls_weight", "effective_reg_weight",
                 "effective_feat_weight"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.teacher.head.msda_impl == got.student.head.msda_impl == "gather4"


def test_teacher_top_k_and_flag_meanings():
    def dcfg(*argv):
        return distill_train.build_bundle(distill_train.parse_args(
            ["--config", "mixdistill_r50_r18_cls_reg_img", *argv]))[1]

    assert dcfg().teacher_top_k == 64
    assert dcfg("--teacher-top-k", "0").teacher_top_k is None
    assert dcfg("--teacher-top-k", "32").teacher_top_k == 32
    d = dcfg()
    assert (d.mix, d.reweight_score, d.use_feat_distill) == (True, True, True)
    assert (d.cls_distill_weight, d.reg_distill_weight,
            d.feat_distill_weight) == (1.0, 0.25, 0.1)
    reg_only = distill_train.build_bundle(distill_train.parse_args(
        ["--config", "distill_r50_r18_reg_2subset"]))[1]
    assert (reg_only.cls_distill_weight, reg_only.reg_distill_weight) == (
        0.0, 1.0)
    with pytest.raises(SystemExit):
        distill_train.parse_args(["--teacher-msda", "shift4h"])
    bundle, _ = distill_train.build_bundle(distill_train.parse_args(
        ["--split-teacher", "--teacher-msda", "shift4h"]))
    assert bundle.teacher.head.msda_impl == "shift4h"


def test_distill_train_then_distill_test(tmp_path):
    wd = str(tmp_path / "wd")
    step, records = distill_train.main(
        ["--tiny", "--synthetic", "--steps", "2", "--device", "cpu",
         "--log-interval", "1", "--work-dir", wd])
    assert [r["step"] for r in records] == [1, 2]
    for k in ("loss", "distill_loss_cls", "distill_loss_reg", "mix_loss_cls",
              "mix_loss_reg", "grad_norm"):
        assert all(k in r and r[k] == r[k] for r in records), k
    with open(os.path.join(wd, "distill_log.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2]
    ckpt = os.path.join(wd, "checkpoints")
    assert CheckpointManager(ckpt).steps() == [2]
    saved = CheckpointManager(ckpt).load_weights()
    student = step.distiller.student.state_dict()
    assert set(saved) == set(student)  # the bare student: no laterals
    for k, v in student.items():
        assert torch.equal(saved[k], v.cpu()), k

    out = distill_test.main(["--tiny", "--device", "cpu", "--checkpoint",
                             ckpt, "--max-samples", "2"])
    assert "mAP" in out["metrics"] and len(out["results"]) == 2
    # the test CLI loads it too
    r = test_cli.main(["--tiny", "--synthetic", "--device", "cpu",
                       "--checkpoint", ckpt, "--max-samples", "1"])
    assert "NDS" in r["metrics"]
    # and it is a teacher checkpoint for another run
    step2, _ = distill_train.main(
        ["--tiny", "--synthetic", "--steps", "1", "--device", "cpu",
         "--teacher-checkpoint", ckpt, "--work-dir", str(tmp_path / "wd2")])
    for k, v in step2.teacher.state_dict().items():
        assert torch.equal(v, saved[k]), k


def test_data_parallel_exits_and_the_clis_need_cuda(tmp_path):
    # --data-parallel N runs one process a rank: one process is 1 rank
    with pytest.raises(SystemExit, match="needs 2 ranks"):
        distill_train.main(["--tiny", "--synthetic", "--device", "cpu",
                            "--data-parallel", "2"])
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is available")
    with pytest.raises(RuntimeError, match="CUDA"):
        distill_train.main(["--tiny", "--synthetic", "--steps", "1",
                            "--work-dir", str(tmp_path / "wd")])
    with pytest.raises(RuntimeError, match="CUDA"):
        distill_test.main(["--tiny", "--max-samples", "1"])
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "graph_detr4d_tpu_torch.tools.distill_test",
         "--tiny", "--max-samples", "1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
