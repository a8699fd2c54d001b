"""nuScenes submission: decoded boxes (lidar frame) -> global-frame
`results_nusc.json` for the official NuScenesEval (counterpart of
graph_detr4d_tpu/eval/submission.py).

As MultiCustomNuScenesDataset._format_bbox / output_to_nusc_box /
lidar_nusc_box_to_global (datasets/multi_nuscenes_dataset.py:123-446):
  * yaw -> nuScenes box orientation, -yaw - pi/2 about +z (:390);
  * lidar -> ego (the infos' lidar2ego pose), the per-class BEV range
    filter in the ego frame (:437-441), ego -> global (:442-444);
  * velocity rotated with the box;
  * attribute defaults and the moving / with_rider speed rule (:149-170).
"""

import json
import os
from typing import Sequence

import numpy as np

from ..config import NUSCENES_CLASSES
from ..geometry.transforms import (
    quat_multiply,
    quaternion_to_rotation_matrix,
)

# detection_cvpr_2019 class ranges (nuscenes devkit config)
CLASS_RANGE = {
    "car": 50.0,
    "truck": 50.0,
    "bus": 50.0,
    "trailer": 50.0,
    "construction_vehicle": 50.0,
    "pedestrian": 40.0,
    "motorcycle": 40.0,
    "bicycle": 40.0,
    "traffic_cone": 30.0,
    "barrier": 30.0,
}

DEFAULT_ATTRIBUTE = {
    "car": "vehicle.parked",
    "pedestrian": "pedestrian.moving",
    "trailer": "vehicle.parked",
    "truck": "vehicle.parked",
    "bus": "vehicle.moving",
    "motorcycle": "cycle.without_rider",
    "construction_vehicle": "vehicle.parked",
    "bicycle": "cycle.without_rider",
    "barrier": "",
    "traffic_cone": "",
}


def _yaw_quat(yaw: float) -> np.ndarray:
    return np.array([np.cos(yaw / 2.0), 0.0, 0.0, np.sin(yaw / 2.0)])


def select_attribute(name: str, velocity) -> str:
    """The reference's speed-based attribute rule (:149-170). Class
    names outside the 10 nuScenes classes get the reference's neutral
    '' fallback instead of crashing the eval loop."""
    if float(np.hypot(velocity[0], velocity[1])) > 0.2:
        if name in (
            "car",
            "construction_vehicle",
            "bus",
            "truck",
            "trailer",
        ):
            return "vehicle.moving"
        if name in ("bicycle", "motorcycle"):
            return "cycle.with_rider"
        return DEFAULT_ATTRIBUTE.get(name, "")
    if name == "pedestrian":
        return "pedestrian.standing"
    if name == "bus":
        return "vehicle.stopped"
    return DEFAULT_ATTRIBUTE.get(name, "")


def boxes_to_nusc_annos(
    boxes: np.ndarray,  # (M, 9) lidar frame (cx cy cz w l h yaw vx vy)
    scores: np.ndarray,
    labels: np.ndarray,
    info: dict,  # needs lidar2ego_* + ego2global_* + token
    classes: Sequence[str] = NUSCENES_CLASSES,
) -> list:
    l2e_q = np.asarray(info["lidar2ego_rotation"], np.float64)
    l2e_t = np.asarray(info["lidar2ego_translation"], np.float64)
    e2g_q = np.asarray(info["ego2global_rotation"], np.float64)
    e2g_t = np.asarray(info["ego2global_translation"], np.float64)
    l2e_R = quaternion_to_rotation_matrix(l2e_q)
    e2g_R = quaternion_to_rotation_matrix(e2g_q)

    annos = []
    for box, score, label in zip(boxes, scores, labels):
        cx, cy, cz, w, l, h, yaw = box[:7]
        vx, vy = (box[7], box[8]) if box.shape[0] > 8 else (0.0, 0.0)
        name = classes[int(label)]
        # nuScenes box orientation convention (:390)
        q = _yaw_quat(-float(yaw) - np.pi / 2.0)
        center = np.array([cx, cy, cz], np.float64)
        vel = np.array([vx, vy, 0.0], np.float64)

        # lidar -> ego
        center = l2e_R @ center + l2e_t
        q = quat_multiply(l2e_q, q)
        vel = l2e_R @ vel
        # per-class BEV range filter in the ego frame (:437-441)
        if np.hypot(center[0], center[1]) > CLASS_RANGE.get(name, 50.0):
            continue
        # ego -> global
        center = e2g_R @ center + e2g_t
        q = quat_multiply(e2g_q, q)
        vel = e2g_R @ vel

        annos.append(
            {
                "sample_token": info["token"],
                "translation": center.tolist(),
                "size": [float(w), float(l), float(h)],
                "rotation": np.asarray(q, np.float64).tolist(),
                "velocity": vel[:2].tolist(),
                "detection_name": name,
                "detection_score": float(score),
                "attribute_name": select_attribute(name, (vx, vy)),
            }
        )
    return annos


def write_submission(
    per_sample: dict,  # sample_token -> list of annos
    out_dir: str,
    meta: dict | None = None,
) -> str:
    """Serialize `results_nusc.json` (:182-196)."""
    os.makedirs(out_dir, exist_ok=True)
    payload = {
        "meta": meta
        or {
            "use_camera": True,
            "use_lidar": False,
            "use_radar": False,
            "use_map": False,
            "use_external": False,
        },
        "results": per_sample,
    }
    path = os.path.join(out_dir, "results_nusc.json")
    with open(path, "w") as f:
        json.dump(payload, f)
    return path
