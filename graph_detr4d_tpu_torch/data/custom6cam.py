"""Generic 6-camera dataset with center2lidar calibration (counterpart of
graph_detr4d_tpu/data/custom6cam.py; the format of the reference's
InternalDatasetSweep, datasets/internal_dataset_sweep.py:17-160).

Info layout per sample (a pickled {'infos': [...]}):
  {
    'timestamp': int (us),
    'center2lidar': (4, 4) row-major list,
    'cams': {cam_name: {'timestamp': us, 'data_path': str,
                        'cam_intrinsic': 9 floats (3x3),
                        'extrinsic': 16 floats (4x4 lidar2cam)}},
    'gt_boxes': (M, 7), 'gt_names': [str] * M,
  }

lidar2img (:91-96) is viewpad @ (extrinsic @ center2lidar): boxes and
queries live in the vehicle-centre frame.
"""

import pickle
from typing import Sequence, Tuple

import numpy as np

DEFAULT_CLASSES = (
    "VEHICLE_CAR",
    "VEHICLE_TRUCK",
    "BIKE_BICYCLE",
    "PEDESTRIAN",
)

DEFAULT_CAMS = (
    "center_camera_fov120",
    "left_front_camera",
    "left_rear_camera",
    "rear_camera",
    "right_rear_camera",
    "right_front_camera",
)


class Custom6CamDataset:
    def __init__(
        self,
        ann_file: str,
        *,
        classes: Sequence[str] = DEFAULT_CLASSES,
        cams: Sequence[str] = DEFAULT_CAMS,
        max_gt: int = 128,
        test_mode: bool = False,
    ):
        with open(ann_file, "rb") as f:
            data = pickle.load(f)
        infos = data["infos"] if isinstance(data, dict) else data
        self.infos = sorted(infos, key=lambda e: e["timestamp"])
        self.classes = tuple(classes)
        self.cams = tuple(cams)
        self.max_gt = max_gt
        self.test_mode = test_mode

    def __len__(self):
        return len(self.infos)

    def calib(self, info) -> Tuple[list, np.ndarray, np.ndarray]:
        """paths, lidar2img (N,4,4), intrinsics (N,4,4) — center frame."""
        center2lidar = np.asarray(info["center2lidar"], np.float64).reshape(
            4, 4
        )
        paths, l2is, intrs = [], [], []
        for cam in self.cams:
            c = info["cams"][cam]
            K = np.asarray(c["cam_intrinsic"], np.float64).reshape(3, 3)
            ext = np.asarray(c["extrinsic"], np.float64).reshape(4, 4)
            ext = ext @ center2lidar  # center2cam (:92)
            viewpad = np.eye(4)
            viewpad[:3, :3] = K
            paths.append(c["data_path"])
            l2is.append(viewpad @ ext)
            intrs.append(viewpad)
        return (
            paths,
            np.asarray(l2is, np.float32),
            np.asarray(intrs, np.float32),
        )

    def padded_gt(self, info):
        boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 7))), np.float32)
        if boxes.shape[0] and boxes.shape[1] == 7:
            boxes = np.concatenate(
                [boxes, np.zeros((boxes.shape[0], 2), np.float32)], axis=1
            )  # zero velocity (:121-122)
        names = info.get("gt_names", [])
        labels = np.asarray(
            [
                self.classes.index(n) if n in self.classes else -1
                for n in names
            ],
            np.int64,
        )
        keep = labels >= 0
        boxes, labels = boxes[keep], labels[keep]
        M = self.max_gt
        out_b = np.zeros((M, 9), np.float32)
        out_l = np.zeros((M,), np.int32)
        out_v = np.zeros((M,), np.float32)
        m = min(len(boxes), M)
        out_b[:m] = boxes[:m]
        out_l[:m] = labels[:m]
        out_v[:m] = 1.0
        return out_b, out_l, out_v

    def sample(self, idx: int) -> dict:
        info = self.infos[idx]
        paths, l2i, intr = self.calib(info)
        gtb, gtl, gtv = self.padded_gt(info)
        return {
            "image_paths": paths,
            "lidar2img": l2i,
            "intrinsics": intr,
            "timestamp": info["timestamp"] / 1e6,
            "gt_bboxes": gtb,
            "gt_labels": gtl,
            "gt_valid": gtv,
        }
