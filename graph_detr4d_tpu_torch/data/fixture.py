"""A synthetic nuScenes-layout dataset on disk, for smoke runs and tests.

    ann_file, encoder = write_nuscenes_fixture(out_dir, num_samples=4)

Writes `out_dir/infos.pkl` in the reference's infos layout (what
data/nuscenes.py::NuScenesSweepDataset reads: `cams` with calibration and
ego poses, `sweeps`, the lidar and ego poses, GT boxes with names,
velocities, valid flags and attribute names) and one JPEG per camera and
frame. Everything comes from one seed: a surround rig of 6 cameras with
nuScenes-like intrinsics, an ego pose per sample, a previous frame 0.5 s
earlier 4 m behind, smooth random images and 5-40 boxes a sample over the
10 classes. `encoder` names the JPEG writer used: OpenCV's where it is
installed, else Pillow's (the decoder order of data/pipeline.py).
"""

import os
import pickle
from typing import Tuple

import numpy as np

from ..geometry.transforms import quaternion_to_rotation_matrix
from .nuscenes import CAM_ORDER, NUSCENES_NAME_TO_LABEL

# class -> (w, l, h) mean size in metres
_SIZES = {"car": (1.9, 4.6, 1.7), "truck": (2.5, 7.0, 2.9),
          "construction_vehicle": (2.8, 6.4, 3.2), "bus": (2.9, 11.0, 3.5),
          "trailer": (2.9, 12.0, 3.9), "barrier": (2.5, 0.5, 1.0),
          "motorcycle": (0.8, 2.1, 1.5), "bicycle": (0.6, 1.7, 1.3),
          "pedestrian": (0.7, 0.7, 1.8), "traffic_cone": (0.4, 0.4, 1.1)}
_ATTRS = {"car": "vehicle.parked", "truck": "vehicle.moving",
          "bus": "vehicle.moving", "trailer": "vehicle.parked",
          "construction_vehicle": "vehicle.parked",
          "motorcycle": "cycle.with_rider", "bicycle": "cycle.without_rider",
          "pedestrian": "pedestrian.moving", "barrier": "",
          "traffic_cone": ""}
# camera (x right, y down, z forward) -> ego (x forward, y left, z up)
_CAM_AXES = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])


def _yaw_quat(yaw: float) -> np.ndarray:
    return np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])


def _matrix_quat(m: np.ndarray) -> np.ndarray:
    """(w, x, y, z) of a rotation matrix whose trace is above -1."""
    w = np.sqrt(1.0 + np.trace(m)) / 2.0
    return np.array([w, (m[2, 1] - m[1, 2]) / (4 * w),
                     (m[0, 2] - m[2, 0]) / (4 * w),
                     (m[1, 0] - m[0, 1]) / (4 * w)])


def _interp_matrix(n: int, m: int) -> np.ndarray:
    """(n, m) linear interpolation from m grid points onto n pixels."""
    pos = np.linspace(0, m - 1, n, dtype=np.float32)
    i0 = np.minimum(pos.astype(int), m - 2)
    frac = pos - i0
    w = np.zeros((n, m), np.float32)
    w[np.arange(n), i0] = 1 - frac
    w[np.arange(n), i0 + 1] = frac
    return w


def _image(rng: np.random.RandomState, hw: Tuple[int, int]) -> np.ndarray:
    """Smooth random RGB uint8: a coarse random grid (a point every 32
    pixels) interpolated linearly, separably."""
    H, W = hw
    coarse = rng.rand(3, H // 32 + 2, W // 32 + 2).astype(np.float32) * 255
    ry, rx = _interp_matrix(H, coarse.shape[1]), _interp_matrix(W, coarse.shape[2])
    img = ry @ coarse @ rx.T  # (3, H, W)
    return np.ascontiguousarray(img.transpose(1, 2, 0).round().astype(np.uint8))


def _writer():
    try:
        import cv2

        def write(path, rgb):
            if not cv2.imwrite(path, rgb[..., ::-1],
                               [cv2.IMWRITE_JPEG_QUALITY, 90]):
                raise OSError(f"cv2 could not write {path}")
        return "cv2", write
    except ImportError:
        from PIL import Image

        def write(path, rgb):
            Image.fromarray(rgb).save(path, quality=90)
        return "PIL", write


def write_nuscenes_fixture(out_dir: str, num_samples: int = 4,
                           src_hw: Tuple[int, int] = (900, 1600),
                           num_sweeps: int = 5, seed: int = 0,
                           gt_range: Tuple[int, int] = (5, 40)):
    """Write the dataset; returns (infos pkl path, JPEG encoder name).

    Each sample has 6 current cameras and `num_sweeps` sweep entries that
    all point at one previous frame of 6 cameras (as a short scene's
    repeated keyframe), so 12 JPEGs a sample."""
    rng = np.random.RandomState(seed)
    encoder, write = _writer()
    os.makedirs(out_dir, exist_ok=True)
    H, W = src_hw
    K = np.array([[0.8 * W, 0.0, W / 2], [0.0, 0.8 * W, H / 2], [0, 0, 1.0]])
    l2e_q, l2e_t = np.array([1.0, 0, 0, 0]), np.array([0.94, 0.0, 1.84])
    names = list(NUSCENES_NAME_TO_LABEL)
    infos = []
    for s in range(num_samples):
        ts = 1_533_151_603_000_000 + s * 500_000
        yaw_e = rng.uniform(-np.pi, np.pi)
        e2g_t = np.array([600.0 + 10 * s, 1600.0 + 5 * s, 0.0])
        e2g_q = _yaw_quat(yaw_e)
        back = quaternion_to_rotation_matrix(e2g_q) @ np.array([-4.0, 0, 0])
        sweep_q, sweep_t = e2g_q, e2g_t + back
        cams, sweep = {}, {}
        for j, cam in enumerate(CAM_ORDER):
            yaw_c = 2 * np.pi * j / len(CAM_ORDER)
            R_ce = quaternion_to_rotation_matrix(_yaw_quat(yaw_c)) @ _CAM_AXES
            t_ce = quaternion_to_rotation_matrix(_yaw_quat(yaw_c)) @ np.array(
                [1.0, 0.0, 1.5])
            paths = []
            for frame in ("cur", "prev"):
                p = os.path.join(out_dir, f"{s:03d}_{frame}_{cam}.jpg")
                write(p, _image(rng, src_hw))
                paths.append(p)
            cams[cam] = {
                "data_path": paths[0],
                "cam_intrinsic": K.copy(),
                "sensor2ego_rotation": _matrix_quat(R_ce),
                "sensor2ego_translation": t_ce,
                # lidar2ego is a pure translation here
                "sensor2lidar_rotation": R_ce,
                "sensor2lidar_translation": t_ce - l2e_t,
                "ego2global_rotation": e2g_q,
                "ego2global_translation": e2g_t,
                "timestamp": ts + 1000 * j,
            }
            sweep[cam] = {
                "data_path": paths[1],
                "ego2global_rotation": sweep_q,
                "ego2global_translation": sweep_t,
                "timestamp": ts - 500_000 + 1000 * j,
            }
        n = rng.randint(gt_range[0], gt_range[1] + 1)
        labels = rng.randint(0, len(names), n)
        gt_names = np.array([names[k] for k in labels])
        r, a = rng.uniform(4.0, 45.0, n), rng.uniform(-np.pi, np.pi, n)
        sizes = np.array([_SIZES[k] for k in gt_names]) * rng.uniform(
            0.9, 1.1, (n, 3))
        boxes = np.concatenate([
            np.stack([r * np.cos(a), r * np.sin(a),
                      rng.uniform(-1.5, 0.5, n)], 1),
            sizes, rng.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32)
        infos.append({
            "token": f"fixture{s:04d}", "timestamp": ts, "cams": cams,
            "sweeps": [sweep] * num_sweeps,
            "lidar2ego_rotation": l2e_q, "lidar2ego_translation": l2e_t,
            "ego2global_rotation": e2g_q, "ego2global_translation": e2g_t,
            "gt_boxes": boxes, "gt_names": gt_names,
            "gt_velocity": (rng.randn(n, 2) * 2).astype(np.float32),
            "valid_flag": rng.rand(n) > 0.1,
            "gt_attrs": np.array([_ATTRS[k] for k in gt_names], object),
        })
    path = os.path.join(out_dir, "infos.pkl")
    with open(path, "wb") as f:
        pickle.dump({"infos": infos, "metadata": {"version": "fixture"}}, f)
    return path, encoder

