"""The slice end to end on the CPU: fixture -> datasets -> build_batch ->
model -> decode against the JAX package, checkpoints and resume, the
reference-layout checkpoint reader, the input prefetch threads, and the
train / test CLIs (`--device cpu --tiny`).

  * whole slice: a nuScenes-layout fixture (data/fixture.py, 90x160
    JPEGs) through both packages' dataset and build_batch (bit-equal),
    then tiny_test_config's GraphDETR4D with the same weights
    (weights.state_dict_from_jax): raw head outputs within 2e-4
    (tests/test_golden_full_model.py), the decode as
    tests/test_torch_slice.py holds it;
  * weights.load_reference_checkpoint on a .pth of
    tools/convert_checkpoint.py::export_state_dict plus BatchNorm's
    num_batches_tracked and a meta entry;
  * Trainer.resume: a run saved after step 1 and resumed (weights, AdamW,
    schedule, the grid-mask / dropout generator) matches the run that
    went on, within 1e-6, with the grid mask and dropout on;
  * the CLIs: train 3 steps (checkpoint at 2), resume to 4, an eval hook
    and a profiled step; test from the checkpoint directory and from a
    .pth (identical answers), the submission json, resized TTA copies,
    the custom6cam format; without CUDA and without `--device cpu` they
    raise, and `--cam-parallel 2` in one process raises (1 rank is not
    divisible by 2).
"""

import itertools
import json
import os
import subprocess
import sys
import threading
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tests.test_torch_modules import jax_vars  # noqa: E402
from tests.test_torch_variants import jax_model_and_weights, variant_config  # noqa: E402
from tools.convert_checkpoint import export_state_dict  # noqa: E402

from graph_detr4d_tpu import config as jax_config  # noqa: E402
from graph_detr4d_tpu.core.coder import decode_batch as jax_decode  # noqa: E402
from graph_detr4d_tpu.data import nuscenes as jax_nusc  # noqa: E402
from graph_detr4d_tpu.data import pipeline as jax_pipe  # noqa: E402
from graph_detr4d_tpu_torch import config as port_config  # noqa: E402
from graph_detr4d_tpu_torch.core.coder import decode_batch  # noqa: E402
from graph_detr4d_tpu_torch.data import nuscenes as port_nusc  # noqa: E402
from graph_detr4d_tpu_torch.data import pipeline as port_pipe  # noqa: E402
from graph_detr4d_tpu_torch.data.fixture import write_nuscenes_fixture  # noqa: E402
from graph_detr4d_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D  # noqa: E402
from graph_detr4d_tpu_torch.tools import test as test_cli  # noqa: E402
from graph_detr4d_tpu_torch.tools import train as train_cli  # noqa: E402
from graph_detr4d_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from graph_detr4d_tpu_torch.train.trainer import PrefetchIterator, Trainer  # noqa: E402
from graph_detr4d_tpu_torch.weights import (  # noqa: E402
    init_weights, load_reference_checkpoint, state_dict_from_jax)

ATOL = 2e-4
SRC_HW = (90, 160)
# tiny_test_config at the fixture's 12 cameras (6 current + 6 previous)
TINY12 = ["--tiny", "--cfg-options", "head.num_cams=12",
          "head.num_frame_cams=6"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several test processes at
    once, and tiny training steps gain nothing from more."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ann_file(tmp_path_factory):
    path, _ = write_nuscenes_fixture(str(tmp_path_factory.mktemp("nusc")),
                                     num_samples=4, src_hw=SRC_HW, seed=11)
    return path


@pytest.fixture(scope="module")
def jax_tiny(ann_file):
    """The JAX tiny model (6 current cameras, dropout 0) and its weights,
    and one eval sample of the fixture through both packages."""
    jcfg, tcfg = variant_config(jax_config), variant_config(port_config)
    samples = [ds(ann_file, test_mode=True).sample(1, temporal=False)
               for ds in (port_nusc.NuScenesSweepDataset,
                          jax_nusc.NuScenesSweepDataset)]
    batches = [pipe.build_batch([s], tcfg.img_size, src_hw=SRC_HW)
               for s, pipe in zip(samples, (port_pipe, jax_pipe))]
    model, v = jax_model_and_weights(jcfg, batches[1]["images"],
                                     batches[1]["lidar2img"], seed=5)
    return jcfg, tcfg, model, v, batches


def test_whole_slice_matches_jax(jax_tiny):
    jcfg, tcfg, model, v, (ours, theirs) = jax_tiny
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert ours["images"].shape == (1, 6, 64, 128, 3)
    want = jax.jit(model.apply)(jax_vars(v), jnp.asarray(theirs["images"]),
                                jnp.asarray(theirs["lidar2img"]))
    port = GraphDETR4D(tcfg, device="cpu")
    port.load_state_dict(state_dict_from_jax(v), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(ours["images"]),
                   torch.from_numpy(ours["lidar2img"]))
    for key in ("all_cls_scores", "all_bbox_preds"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=ATOL, err_msg=key)
    kw = dict(max_num=jcfg.coder.max_num,
              post_center_range=jcfg.coder.post_center_range)
    dj, dt = jax_decode(want, **kw), decode_batch(got, **kw)
    vj = np.asarray(dj.valid)
    np.testing.assert_array_equal(dt.valid.numpy(), vj)
    assert vj.any()
    np.testing.assert_array_equal(dt.labels.numpy(), np.asarray(dj.labels))
    np.testing.assert_allclose(dt.bboxes.numpy()[vj], np.asarray(dj.bboxes)[vj],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(dt.scores.numpy(), np.asarray(dj.scores),
                               rtol=0, atol=ATOL)


def test_load_reference_checkpoint(jax_tiny, tmp_path):
    jcfg, tcfg, _, v, _ = jax_tiny
    sd = {k: torch.from_numpy(np.array(x, np.float32)) for k, x in
          export_state_dict(v, jcfg.head.num_decoder_layers,
                            jcfg.head.num_heads).items()}
    bn = [k[: -len("running_mean")] for k in sd if k.endswith("running_mean")]
    assert bn
    for k in bn:
        sd[k + "num_batches_tracked"] = torch.tensor(100)
    path = str(tmp_path / "upstream.pth")
    torch.save({"meta": {"epoch": 12, "CLASSES": ("car",)}, "state_dict": sd},
               path)
    port = GraphDETR4D(tcfg, device="cpu")
    loaded = load_reference_checkpoint(path, port)
    want = state_dict_from_jax(v)
    assert set(loaded) == set(want)
    for k in want:
        assert torch.equal(port.state_dict()[k], want[k]), k
    torch.save(dict(sd), str(tmp_path / "bare.pth"))  # a bare state_dict
    assert set(load_reference_checkpoint(str(tmp_path / "bare.pth"))) == set(want)


def _tiny_trainer(work_dir, batches, seed=0):
    cfg = port_config.tiny_test_config()
    model = GraphDETR4D(cfg, device="cpu")
    init_weights(model, 3)
    return cfg, Trainer(cfg, model.state_dict(), iter(batches), str(work_dir),
                        device="cpu", seed=seed)


def test_resume_matches_the_uninterrupted_run(tmp_path):
    cfg = port_config.tiny_test_config()
    assert cfg.train.use_grid_mask and cfg.head.dropout > 0
    batches = [synthetic_batch(cfg, seed=s, num_gt=6) for s in (1, 2, 3)]
    _, straight = _tiny_trainer(tmp_path / "a", batches)
    rec_a = straight.fit(3, log_interval=1)
    straight.close()

    _, first = _tiny_trainer(tmp_path / "b", batches[:1])
    first.fit(1, log_interval=1, ckpt_every=1)
    first.close()
    saved = CheckpointManager(str(tmp_path / "b" / "checkpoints")).restore()
    assert saved["step"] == 1 and saved["meta"]["step"] == 1
    assert saved["meta"]["config"]["head"]["num_query"] == cfg.head.num_query
    _, resumed = _tiny_trainer(tmp_path / "b", batches[1:], seed=99)
    assert resumed.resume() == 1
    for k, t in first.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], t), k
    assert torch.equal(resumed.train_step.generator.get_state(),
                       first.train_step.generator.get_state())
    opt_a = first.train_step.optimizer.state_dict()
    opt_b = resumed.train_step.optimizer.state_dict()
    assert opt_a["param_groups"] == opt_b["param_groups"]
    for i, st in opt_a["state"].items():
        for k, t in st.items():
            assert torch.equal(opt_b["state"][i][k], t), (i, k)
    assert resumed.train_step.scheduler.last_epoch == 1
    rec_b = resumed.fit(3, log_interval=1, ckpt_every=10)
    resumed.close()
    assert [r["step"] for r in rec_b] == [2, 3]
    for ra, rb in zip(rec_a[1:], rec_b):
        assert abs(ra["loss"] - rb["loss"]) <= 1e-6 * max(1.0, abs(ra["loss"]))
    for k, t in straight.model.state_dict().items():
        torch.testing.assert_close(resumed.model.state_dict()[k], t,
                                   rtol=0, atol=1e-6, msg=k)
    # the end of fit saved step 3 beside step 1
    assert CheckpointManager(str(tmp_path / "b" / "checkpoints")).steps() == [1, 3]


def test_checkpoint_manager_rotation_and_weights(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=3)
    assert mgr.latest_step() is None and mgr.restore() is None
    for step in range(1, 6):
        mgr.save(step, {"state_dict": {"w": torch.full((2,), float(step))}},
                 metrics={"loss": step / 2})
    assert mgr.steps() == [3, 4, 5]
    assert mgr.restore(4)["meta"]["metrics"] == {"loss": 2.0}
    mgr.save_weights(6, {"w": torch.ones(2)})
    assert mgr.steps() == [4, 5, 6]
    assert set(mgr.restore()) == {"state_dict", "meta"}
    assert torch.equal(mgr.load_weights(5)["w"], torch.full((2,), 5.0))
    assert not [f for f in os.listdir(mgr.directory) if f.endswith(".tmp")]


def test_prefetch_surfaces_errors_and_stops():
    def failing():
        yield 1
        raise ValueError("decode failed")

    it = PrefetchIterator(failing(), depth=1)
    assert next(it) == 1
    with pytest.raises(ValueError, match="decode failed"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)
    it.close()

    def endless():
        n = 0
        while True:
            n += 1
            yield n

    it = PrefetchIterator(endless(), depth=2, name="endless")
    assert [next(it) for _ in range(3)] == [1, 2, 3]
    it.close(timeout=10)
    assert not it._thread.is_alive()


def test_trainer_surfaces_a_pipeline_error(tmp_path):
    cfg = port_config.tiny_test_config()
    batch = synthetic_batch(cfg, seed=0)

    def bad_batches():
        yield batch
        raise OSError("missing jpeg")

    model = GraphDETR4D(cfg, device="cpu")
    trainer = Trainer(cfg, model.state_dict(), bad_batches(), str(tmp_path),
                      device="cpu")
    with pytest.raises(OSError, match="missing jpeg"):
        trainer.fit(5, log_interval=1)
    assert trainer.step == 1
    trainer.close()
    names = {t.name for t in threading.enumerate()}
    assert not names & {"trainer-host-pipeline", "trainer-transfer"}


def test_dropped_trainer_stops_its_threads(tmp_path):
    """A Trainer dropped without close() is freed at once (its input
    threads hold no reference to it) and its threads are joined."""
    cfg = port_config.tiny_test_config()
    model = GraphDETR4D(cfg, device="cpu")
    trainer = Trainer(cfg, model.state_dict(),
                      itertools.repeat(synthetic_batch(cfg, seed=0)),
                      str(tmp_path), device="cpu")
    trainer.fit(1, log_interval=1)
    ref = weakref.ref(trainer)
    del trainer
    assert ref() is None
    names = {t.name for t in threading.enumerate()}
    assert not names & {"trainer-host-pipeline", "trainer-transfer"}


def test_cli_train_resume_and_test(ann_file, tmp_path):
    wd = str(tmp_path / "wd")
    common = TINY12 + ["--device", "cpu", "--work-dir", wd, "--ann-file",
                       ann_file, "--load-interval", "1", "--log-interval", "1",
                       "--ckpt-every", "2"]
    t1 = train_cli.main(common + ["--total-steps", "3", "--val-ann-file",
                                  ann_file, "--eval-samples", "1",
                                  "--profile-steps", "1"])
    assert t1.step == 3
    ck = os.path.join(wd, "checkpoints")
    assert CheckpointManager(ck).steps() == [2, 3]
    with open(os.path.join(wd, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    steps = [r["step"] for r in log if "loss" in r]
    assert steps == [1, 2, 3]
    evals = [r for r in log if "val_mAP" in r]
    assert [r["step"] for r in evals] == [2, 3]
    assert all(np.isfinite(r["loss"]) and r["data_time"] > 0 for r in log
               if "loss" in r)
    assert os.path.exists(os.path.join(wd, "profile", "trace.json"))
    assert t1.profile_summary["steps"] == 1

    t2 = train_cli.main(common + ["--total-steps", "4", "--resume"])
    assert t2.step == 4 and CheckpointManager(ck).steps() == [2, 3, 4]
    assert t2.train_step.scheduler.last_epoch == 4
    names = {t.name for t in threading.enumerate()}
    assert not any(n.startswith("trainer-") for n in names), names
    assert port_pipe._DECODE_POOL is None  # its decode threads stopped

    test_args = TINY12 + ["--device", "cpu", "--ann-file", ann_file,
                          "--max-samples", "2"]
    r_dir = test_cli.main(test_args + ["--checkpoint", ck, "--format-nusc",
                                       str(tmp_path / "nusc"), "--out",
                                       str(tmp_path / "res.json")])
    assert len(r_dir["results"]) == 2 and r_dir["cam_overflow"] == [0.0] * 2
    assert {"mAP", "NDS", "mATE"} <= set(r_dir["metrics"])
    with open(tmp_path / "nusc" / "results_nusc.json") as f:
        sub = json.load(f)
    assert set(sub["results"]) == {r["token"] for r in r_dir["results"]}
    with open(tmp_path / "res.json") as f:
        assert json.load(f)["results"] == r_dir["results"]

    pth = str(tmp_path / "weights.pth")
    torch.save({"state_dict": t2.model.state_dict(), "meta": {"step": 4}}, pth)
    r_pth = test_cli.main(test_args + ["--checkpoint", pth])
    assert r_pth["results"] == r_dir["results"]
    assert r_pth["metrics"] == r_dir["metrics"]

    r_tta = test_cli.main(test_args[:-1] + ["1", "--checkpoint", pth,
                                            "--tta-resizes", "1.0,0.9,1.1"])
    assert len(r_tta["results"]) == 1
    assert r_tta["results"][0] != r_dir["results"][0]


def test_cli_test_custom6cam_and_synthetic(tmp_path):
    import pickle

    from PIL import Image

    from graph_detr4d_tpu_torch.data.custom6cam import DEFAULT_CAMS

    rng = np.random.RandomState(0)
    cams = {}
    for i, cam in enumerate(DEFAULT_CAMS):
        p = str(tmp_path / f"{cam}.jpg")
        Image.fromarray(rng.randint(0, 256, (64, 128, 3)).astype(np.uint8)).save(p)
        ext = np.eye(4)
        ext[:3, 3] = [0.1 * i, 0.0, 0.0]
        cams[cam] = {"timestamp": 1_000_000 + i, "data_path": p,
                     "cam_intrinsic": [500.0, 0, 64, 0, 500.0, 32, 0, 0, 1],
                     "extrinsic": ext.reshape(-1).tolist()}
    info = {"timestamp": 1_000_000, "center2lidar": np.eye(4).tolist(),
            "cams": cams, "gt_boxes": rng.randn(2, 7).astype(np.float32),
            "gt_names": ["VEHICLE_CAR", "PEDESTRIAN"]}
    ann = str(tmp_path / "c6.pkl")
    with open(ann, "wb") as f:
        pickle.dump({"infos": [info]}, f)
    r = test_cli.main(["--tiny", "--device", "cpu", "--dataset", "custom6cam",
                       "--ann-file", ann])
    assert [x["token"] for x in r["results"]] == ["sample-0"]
    r = test_cli.main(["--tiny", "--device", "cpu", "--synthetic",
                       "--max-samples", "2"])
    assert [x["token"] for x in r["results"]] == ["synthetic-0", "synthetic-1"]


def test_clis_need_cuda_unless_cpu_is_asked_for(ann_file, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is available")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--tiny", "--synthetic", "--total-steps", "1",
                        "--work-dir", str(tmp_path / "wd")])
    with pytest.raises(RuntimeError, match="CUDA"):
        test_cli.main(["--tiny", "--synthetic", "--max-samples", "1"])
    # camera parallelism needs a process group whose size --cam-parallel
    # divides (parallel/mesh.py::make_mesh_2d); one process has 1 rank
    for cli in (train_cli, test_cli):
        with pytest.raises(ValueError, match="not divisible by cam=2"):
            cli.main(["--tiny", "--synthetic", "--device", "cpu",
                      "--cam-parallel", "2"])
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "graph_detr4d_tpu_torch.tools.test", "--tiny",
         "--synthetic", "--max-samples", "1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    proc = subprocess.run(
        [sys.executable, "-m", "graph_detr4d_tpu_torch.tools.train", "--tiny",
         "--synthetic", "--total-steps", "1", "--device", "cpu",
         "--work-dir", str(tmp_path / "m")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert CheckpointManager(str(tmp_path / "m" / "checkpoints")).steps() == [1]
