"""The port's host data path against the JAX package's, on the CPU.

On a nuScenes-layout fixture (data/fixture.py: 90x160 JPEGs, 6 current
cameras and a previous frame, 5-40 GT boxes a sample), seeded inputs go
through both packages and must agree exactly:

  * geometry/transforms.py, data/storage.py;
  * the datasets (NuScenesSweepDataset in train and test mode with its
    sweep draws, CBGSDataset's indices, Custom6CamDataset);
  * data/pipeline.py::build_batch: images, lidar2img, GT, intrinsics,
    ida_scale and mean_time_stamp bit-equal for eval, train with each aug
    switch on and off, multi-scale `resize_scales`, device_normalize,
    BGR normalization and the resized TTA copies, from one RandomState
    seed each;
  * native/: the port's C++ loader against the JAX one on the same JPEGs
    (float, uint8, flipped), and build_batch through it;
  * parallel/transfer.py::cast_for_transfer against the JAX cast;
  * the named configs this slice registers, field by field.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import graph_detr4d_tpu.configs as jax_configs  # noqa: E402
from graph_detr4d_tpu import config as jax_config  # noqa: E402
from graph_detr4d_tpu import native as jax_native  # noqa: E402
from graph_detr4d_tpu.data import custom6cam as jax_c6  # noqa: E402
from graph_detr4d_tpu.data import nuscenes as jax_nusc  # noqa: E402
from graph_detr4d_tpu.data import pipeline as jax_pipe  # noqa: E402
from graph_detr4d_tpu.data import storage as jax_storage  # noqa: E402
from graph_detr4d_tpu.geometry import transforms as jax_tf  # noqa: E402
from graph_detr4d_tpu.parallel.mesh import cast_for_transfer as jax_cast  # noqa: E402

import graph_detr4d_tpu_torch.configs as port_configs  # noqa: E402
from graph_detr4d_tpu_torch import config as port_config  # noqa: E402
from graph_detr4d_tpu_torch import native as port_native  # noqa: E402
from graph_detr4d_tpu_torch.data import custom6cam as port_c6  # noqa: E402
from graph_detr4d_tpu_torch.data import nuscenes as port_nusc  # noqa: E402
from graph_detr4d_tpu_torch.data import pipeline as port_pipe  # noqa: E402
from graph_detr4d_tpu_torch.data import storage as port_storage  # noqa: E402
from graph_detr4d_tpu_torch.data.fixture import write_nuscenes_fixture  # noqa: E402
from graph_detr4d_tpu_torch.geometry import transforms as port_tf  # noqa: E402
from graph_detr4d_tpu_torch.parallel.transfer import (  # noqa: E402
    cast_for_transfer, to_device)

SRC_HW, FINAL_HW = (90, 160), (64, 128)
NEW_CONFIGS = ("detr4d_res50_deform_ms", "detr4d_res50_deform_aug_2subset_12e",
               "detr4d_res50_deform_pe_aug_2subset_12e",
               "detr4d_res50_deform_pe_rotaug_2subset_12e",
               "detr4d_res50_deform_pe_rotcropaug_2subset_12e")


@pytest.fixture(scope="module")
def ann_file(tmp_path_factory):
    path, _ = write_nuscenes_fixture(str(tmp_path_factory.mktemp("nusc")),
                                     num_samples=4, src_hw=SRC_HW, seed=3)
    return path


def assert_same(a, b, where=""):
    """Equal values of the same type, recursively (arrays bit-equal)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, a.keys(), b.keys())
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, (
            where, a.dtype, getattr(b, "dtype", type(b)))
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b and type(a) is type(b), (where, a, b)


def test_geometry_transforms_match_jax():
    rng = np.random.RandomState(0)
    for _ in range(5):
        qs = [q / np.linalg.norm(q) for q in rng.randn(4, 4)]
        ts = list(rng.randn(4, 3) * 10)
        K = np.array([[1266.4, 0, 816.3], [0, 1266.4, 491.5], [0, 0, 1.0]])
        args = (K, qs[0], ts[0], qs[1], ts[1], qs[2], ts[2], qs[3], ts[3])
        assert_same(port_tf.sweep_lidar2img(*args), jax_tf.sweep_lidar2img(*args))
        assert_same(port_tf.sweep_cam_to_current_lidar(*args[1:]),
                    jax_tf.sweep_cam_to_current_lidar(*args[1:]))
        assert_same(port_tf.quaternion_to_rotation_matrix(qs[0] * 3),
                    jax_tf.quaternion_to_rotation_matrix(qs[0] * 3))
        assert_same(port_tf.quat_multiply(qs[0], qs[1]),
                    jax_tf.quat_multiply(qs[0], qs[1]))
        assert_same(port_tf.quat_inverse(qs[2]), jax_tf.quat_inverse(qs[2]))
        assert port_tf.quat_yaw(qs[3]) == jax_tf.quat_yaw(qs[3])
    assert_same(port_tf.quaternion_to_rotation_matrix(np.zeros(4)), np.eye(3))


def test_file_client_matches_jax(tmp_path):
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "f.bin").write_bytes(b"\x01\x02")
    mapping = {"./nusc": str(tmp_path / "data")}
    ours = port_storage.FileClient(path_mapping=mapping)
    theirs = jax_storage.FileClient(path_mapping=mapping)
    for p in ("./nusc/f.bin", "./nusc/missing.bin", "/abs/x"):
        assert ours.resolve(p) == theirs.resolve(p)
        assert ours.exists(p) == theirs.exists(p)
    assert ours.get("./nusc/f.bin") == theirs.get("./nusc/f.bin") == b"\x01\x02"
    with pytest.raises(ValueError):
        port_storage.FileClient(backend="s3")
    try:
        import fsspec  # noqa: F401
        import gcsfs  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="fsspec"):
            port_storage.FileClient(backend="gcs").get("gs://bucket/x")


def _datasets(ann_file, **kw):
    return (port_nusc.NuScenesSweepDataset(ann_file, **kw),
            jax_nusc.NuScenesSweepDataset(ann_file, **kw))


@pytest.mark.parametrize("mode", ["train", "test", "single_frame"])
def test_nuscenes_dataset_matches_jax(ann_file, mode):
    kw = {"train": dict(load_interval=1, seed=5),
          "test": dict(test_mode=True, max_gt=8),
          "single_frame": dict(load_interval=2, sweeps_num=2)}[mode]
    ours, theirs = _datasets(ann_file, **kw)
    assert len(ours) == len(theirs) > 0
    assert ours.metadata == theirs.metadata
    for i in range(len(ours)):
        for temporal in ((False,) if mode == "single_frame" else (True, False)):
            assert_same(ours.sample(i, temporal=temporal),
                        theirs.sample(i, temporal=temporal), f"sample {i}")
    assert port_nusc.CAM_ORDER == jax_nusc.CAM_ORDER
    assert port_nusc.NUSCENES_NAME_TO_LABEL == jax_nusc.NUSCENES_NAME_TO_LABEL


def test_cbgs_matches_jax(ann_file):
    ours, theirs = _datasets(ann_file, load_interval=1, seed=2)
    ours, theirs = port_nusc.CBGSDataset(ours, seed=4), \
        jax_nusc.CBGSDataset(theirs, seed=4)
    assert ours.indices == theirs.indices and len(ours) == len(theirs) > 4
    for i in range(len(ours)):
        assert_same(ours.sample(i), theirs.sample(i), f"cbgs {i}")


def test_custom6cam_matches_jax(tmp_path):
    import pickle

    rng = np.random.RandomState(0)
    infos = []
    for s in range(3):
        cams = {}
        for i, cam in enumerate(port_c6.DEFAULT_CAMS):
            ext = np.eye(4)
            ext[:3, :3] = port_tf.quaternion_to_rotation_matrix(rng.randn(4))
            ext[:3, 3] = rng.randn(3)
            cams[cam] = {"timestamp": 1_000_000 + i,
                         "data_path": f"/x/{s}_{cam}.jpg",
                         "cam_intrinsic": [500.0, 0, 80, 0, 500.0, 45, 0, 0, 1],
                         "extrinsic": ext.reshape(-1).tolist()}
        infos.append({
            "timestamp": 2_000_000 - s, "cams": cams,
            "center2lidar": np.eye(4).reshape(-1).tolist(),
            "gt_boxes": rng.randn(4, 7).astype(np.float32),
            "gt_names": ["VEHICLE_CAR", "not_a_class", "PEDESTRIAN",
                         "BIKE_BICYCLE"]})
    p = str(tmp_path / "infos.pkl")
    with open(p, "wb") as f:
        pickle.dump({"infos": infos}, f)
    ours = port_c6.Custom6CamDataset(p, max_gt=8)
    theirs = jax_c6.Custom6CamDataset(p, max_gt=8)
    for i in range(3):
        assert_same(ours.sample(i), theirs.sample(i), f"sample {i}")


def _aug(pkg, **kw):
    return dataclasses.replace(pkg.TrainConfig(), **kw)


# build_batch settings: (training, aug fields or None for aug=None, kwargs)
CASES = {
    "eval": (False, {}, {}),
    "train_all": (True, {}, {}),
    "train_aug_none": (True, None, {}),
    "train_no_photometric": (True, dict(photometric=False), {}),
    "train_no_ida": (True, dict(ida_aug=False), {}),
    "train_no_rot": (True, dict(rot_aug=False), {}),
    "train_resize_scales": (True, dict(resize_scales=((48, 9999), (72, 9999),
                                                      (110, 9999))), {}),
    "device_normalize_eval": (False, {}, dict(device_normalize=True)),
    "device_normalize_train": (True, {}, dict(device_normalize=True)),
    "bgr_eval": (False, {}, dict(img_norm=((103.53, 116.28, 123.675),
                                           (57.375, 57.12, 58.395), True))),
    "tta": (False, {}, dict(tta_resize_mults=(1.0, 0.9, 1.1))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_build_batch_matches_jax(ann_file, case):
    training, aug_kw, kw = CASES[case]
    ours_ds, theirs_ds = _datasets(ann_file, load_interval=1, seed=1)
    idx = [0, 2] if training else [1]
    batches = []
    for pkg, ds, pipe in ((port_config, ours_ds, port_pipe),
                          (jax_config, theirs_ds, jax_pipe)):
        samples = [ds.sample(i) for i in idx]
        batches.append(pipe.build_batch(
            samples, FINAL_HW, training=training, rng=np.random.RandomState(7),
            src_hw=SRC_HW, aug=None if aug_kw is None else _aug(pkg, **aug_kw),
            **kw))
    ours, theirs = batches
    assert_same(ours, theirs, case)
    n = len(idx)
    shape = (3, n, 12, *FINAL_HW, 3) if case == "tta" else (n, 12, *FINAL_HW, 3)
    assert ours["images"].shape == shape
    for key in ("intrinsics", "ida_scale", "mean_time_stamp"):
        assert key in ours
    if case == "device_normalize_eval":
        assert ours["images"].dtype == np.uint8
    if case == "tta":  # each copy its own ida composed into lidar2img
        assert ours["lidar2img"].shape == (3, n, 12, 4, 4)
        assert not np.array_equal(ours["lidar2img"][0], ours["lidar2img"][1])


def test_tta_copies_carry_the_tta_ida_composition(ann_file):
    """Each TTA copy's lidar2img is _tta_ida's crop (centred in x, from
    the bottom in y) composed in float64 into the sample's lidar2img."""
    ds = port_nusc.NuScenesSweepDataset(ann_file, test_mode=True)
    s = ds.sample(0)
    mults = (1.0, 0.95, 1.05)
    b = port_pipe.build_batch([s], FINAL_HW, src_hw=SRC_HW,
                              tta_resize_mults=mults)
    p = port_pipe.sample_ida_params(np.random.RandomState(0), SRC_HW, FINAL_HW,
                                    training=False)
    for a, m in enumerate(mults):
        r = p.resize * m
        newW, newH = int(SRC_HW[1] * r), int(SRC_HW[0] * r)
        cw, ch = int(max(0, newW - FINAL_HW[1]) / 2), max(0, newH - FINAL_HW[0])
        crop = p.crop if a == 0 else (cw, ch, cw + FINAL_HW[1], ch + FINAL_HW[0])
        ida = port_pipe.IdaAugParams(resize=p.resize if a == 0 else r,
                                     crop=crop, flip=False).ida_mat()
        ida4 = np.eye(4)
        ida4[:2, :2], ida4[:2, 2] = ida[:2, :2], ida[:2, 2]
        want = np.stack([(ida4 @ l).astype(np.float32) for l in s["lidar2img"]])
        np.testing.assert_array_equal(b["lidar2img"][a, 0], want)


def test_load_maps_is_refused_until_petr_seg_is_ported(ann_file):
    s = port_nusc.NuScenesSweepDataset(ann_file, test_mode=True).sample(0)
    s["map_filename"] = "/nowhere/map.npz"
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        port_pipe.build_batch([s], FINAL_HW, src_hw=SRC_HW)


def test_photometric_and_hsv_match_jax():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (20, 30, 3)).astype(np.uint8)
    img[0, 0] = 0  # v == 0 and c == 0 pixels
    img[1, 1] = 128
    for seed in range(8):
        assert_same(
            port_pipe.photometric_distortion(img, np.random.RandomState(seed)),
            jax_pipe.photometric_distortion(img, np.random.RandomState(seed)))
    f = img.astype(np.float32) * 1.3 - 20
    assert_same(port_pipe._hsv_to_rgb(port_pipe._rgb_to_hsv(f)),
                jax_pipe._hsv_to_rgb(jax_pipe._rgb_to_hsv(f)))


def test_resize_helpers_match_jax():
    rng = np.random.RandomState(0)
    imgs = [rng.rand(32, 48, 3).astype(np.float32) * 255 for _ in range(3)]
    l2i = rng.randn(3, 4, 4).astype(np.float32)
    intr = np.tile(np.diag([700.0, 700.0, 1.0, 1.0]), (3, 1, 1))
    boxes = rng.randn(5, 9).astype(np.float32)
    assert_same(port_pipe.scale_aware_resize(imgs, l2i, intr, 0.75),
                jax_pipe.scale_aware_resize(imgs, l2i, intr, 0.75))
    assert_same(port_pipe.random_scale_multiview(imgs, l2i, 1.5),
                jax_pipe.random_scale_multiview(imgs, l2i, 1.5))
    assert_same(port_pipe.random_resize_depth_scaled(imgs, l2i, boxes, (40, 90)),
                jax_pipe.random_resize_depth_scaled(imgs, l2i, boxes, (40, 90)))
    assert_same(port_pipe.pad_to_divisor(imgs[0][:30, :45]),
                jax_pipe.pad_to_divisor(imgs[0][:30, :45]))


@pytest.fixture
def native_build(tmp_path, monkeypatch):
    """The port's native loader built into a temporary directory (never
    into graph_detr4d_tpu_torch/_build while other tests run); skips
    where g++ or libjpeg is missing."""
    monkeypatch.setattr(port_native, "BUILD_DIR", tmp_path / "_build")
    port_native._load.cache_clear()
    yield
    port_native._load.cache_clear()


def test_native_loader_matches_jax(ann_file, native_build):
    if not port_native.available():
        pytest.skip(f"native loader unavailable: {port_native.unavailable_reason()}")
    assert jax_native.available()
    assert port_native.library_path().parent.name == "_build"
    assert str(port_native.library_path()).startswith(str(port_native.BUILD_DIR))
    s = port_nusc.NuScenesSweepDataset(ann_file, test_mode=True).sample(0)
    paths = s["image_paths"]
    for kw in (dict(resize=0.8, crop_xy=(3, 5), out_hw=(64, 96)),
               dict(resize=1.1, crop_xy=(20, 30), out_hw=(64, 128), flip=True),
               dict(resize=0.8, crop_xy=(0, 0), out_hw=(48, 96), raw_uint8=True),
               dict(resize=0.9, crop_xy=(4, 2), out_hw=(64, 96), flip=True,
                    mean=(1.0, 2.0, 3.0), std=(2.0, 3.0, 4.0))):
        assert_same(port_native.load_images(paths, **kw),
                    jax_native.load_images(paths, **kw), str(kw))
    with pytest.raises(RuntimeError, match="1 image"):
        port_native.load_images([paths[0] + ".missing"], out_hw=(8, 8))
    ours_ds, theirs_ds = _datasets(ann_file, load_interval=1)
    for training, kw in ((False, {}), (False, dict(device_normalize=True)),
                         (True, {})):
        batches = [pipe.build_batch(
            [ds.sample(1)], FINAL_HW, training=training, src_hw=SRC_HW,
            rng=np.random.RandomState(3), use_native=True, **kw)
            for ds, pipe in ((ours_ds, port_pipe), (theirs_ds, jax_pipe))]
        assert_same(*batches, f"native training={training} {kw}")


def test_native_loader_reports_a_failed_build(tmp_path, monkeypatch, native_build):
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ reachable
    assert not port_native.available()
    assert port_native.unavailable_reason()
    with pytest.raises(RuntimeError, match="native loader unavailable"):
        port_native.load_images(["x.jpg"], out_hw=(8, 8))


def test_cast_for_transfer_matches_jax():
    rng = np.random.RandomState(0)
    imgs = (rng.randn(1, 2, 4, 6, 3) * 50).astype(np.float32)
    imgs[0, 0, 0, 0] = [1.00390625, -3.0078125, 65504.0]  # rounding ties
    batch = {"images": imgs, "lidar2img": np.eye(4, dtype=np.float32)[None]}
    ours, theirs = cast_for_transfer(batch, True), jax_cast(batch, True)
    assert ours["images"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        ours["images"].view(torch.int16).numpy(),
        np.asarray(theirs["images"]).view(np.int16))
    assert ours["lidar2img"] is batch["lidar2img"]
    assert cast_for_transfer(batch, False) is batch
    u8 = {"images": imgs.astype(np.uint8)}
    assert cast_for_transfer(u8, True) is u8
    dev, done, pinned = to_device(ours, torch.device("cpu"))
    assert done is None and pinned == []
    assert torch.equal(dev["images"], ours["images"])


@pytest.mark.parametrize("name", NEW_CONFIGS)
def test_train_pipeline_configs_equal_jax(name):
    assert name in port_configs.list_configs()
    assert dataclasses.asdict(port_configs.get_config(name)) == \
        dataclasses.asdict(jax_configs.get_config(name))
