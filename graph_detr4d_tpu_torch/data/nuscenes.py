"""nuScenes infos-pkl dataset reader and temporal sweep selection
(counterpart of graph_detr4d_tpu/data/nuscenes.py, numpy, same draws).

Reads the reference's pkl layout (`new_mmdet3d_nuscenes_30f_infos_*.pkl`):
per sample `cams` (6 camera calibrations and paths), `sweeps` (previous
camera frames with ego poses), the LiDAR calibration and the GT boxes.

  * per-camera lidar2img: nuscenes_dataset.py:56-68;
  * sweep choice: train draws from sweep_range [3, 27), test takes the
    fixed mid-range index (loading.py:104-118);
  * sweep ego-motion alignment: loading.py:136-183, through
    geometry.transforms.sweep_lidar2img;
  * `load_interval` subsampling (configs/...12e.py:196) and CBGS
    class-balanced resampling (CBGSDataset).
"""

import pickle
from typing import List, Optional

import numpy as np

from ..geometry.transforms import (
    lidar2img_from_calib,
    quaternion_to_rotation_matrix,
    sweep_lidar2img,
)

CAM_ORDER = (
    "CAM_FRONT",
    "CAM_FRONT_RIGHT",
    "CAM_FRONT_LEFT",
    "CAM_BACK",
    "CAM_BACK_LEFT",
    "CAM_BACK_RIGHT",
)

NUSCENES_NAME_TO_LABEL = {
    "car": 0,
    "truck": 1,
    "construction_vehicle": 2,
    "bus": 3,
    "trailer": 4,
    "barrier": 5,
    "motorcycle": 6,
    "bicycle": 7,
    "pedestrian": 8,
    "traffic_cone": 9,
}


class NuScenesSweepDataset:
    """Iterates reference-format infos; yields per-sample dicts of image
    paths + dense lidar2img (12, 4, 4) + padded GT."""

    def __init__(
        self,
        ann_file: str,
        *,
        load_interval: int = 1,
        sweeps_num: int = 1,
        sweep_range=(3, 27),
        test_mode: bool = False,
        use_valid_flag: bool = True,
        max_gt: int = 128,
        seed: int = 0,
    ):
        with open(ann_file, "rb") as f:
            data = pickle.load(f)
        infos = data["infos"] if isinstance(data, dict) else data
        infos = sorted(infos, key=lambda e: e["timestamp"])
        self.infos = infos[::load_interval]
        self.metadata = data.get("metadata") if isinstance(data, dict) else None
        self.sweeps_num = sweeps_num
        self.sweep_range = sweep_range
        self.test_mode = test_mode
        self.use_valid_flag = use_valid_flag
        self.max_gt = max_gt
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.infos)

    # -- calibration ------------------------------------------------------
    def current_frame_calib(self, info) -> tuple[list, np.ndarray]:
        paths, mats = [], []
        for cam in CAM_ORDER:
            c = info["cams"][cam]
            paths.append(c["data_path"])
            mats.append(
                lidar2img_from_calib(
                    c["cam_intrinsic"],
                    c["sensor2lidar_rotation"],
                    c["sensor2lidar_translation"],
                )
            )
        return paths, np.asarray(mats, np.float32)

    def choose_sweep(self, info) -> Optional[int]:
        idxs = self.choose_sweeps(info)
        return None if idxs is None else idxs[0]

    def choose_sweeps(self, info) -> Optional[list]:
        """Sweep-frame index choice list (loading.py:106-123): train draws
        `sweeps_num` distinct indices from sweep_range, test uses the fixed
        mid-range index. Static-shape deviation: the reference emits
        however many frames the choice list yields (fewer when sweeps are
        scarce, one at test time regardless of sweeps_num); here the list
        is always padded to exactly `sweeps_num` entries by repeating the
        last choice, so the camera axis keeps its jit-static size."""
        sweeps = info.get("sweeps", [])
        if not sweeps:
            return None
        lo, hi = self.sweep_range
        n = self.sweeps_num
        if len(sweeps) <= n:
            choices = list(range(len(sweeps)))  # loading.py:109-110
        elif self.test_mode:
            choices = [min(int((lo + hi) / 2) - 1, len(sweeps) - 1)]
        elif lo < len(sweeps):
            pool = list(range(lo, min(hi, len(sweeps))))
            take = min(n, len(pool))
            choices = [
                int(i) for i in self.rng.choice(pool, take, replace=False)
            ]
        else:
            choices = [min(int((lo + hi) / 2) - 1, len(sweeps) - 1)]
        while len(choices) < n:  # static-shape pad
            choices.append(choices[-1])
        return choices

    def mean_time_stamp(self, info, sweep_idx) -> float:
        """PETRv2's temporal delta in seconds (petrv2_head.py:488-494 +
        loading.py:87-89, 133-134): mean over cams of
        (lidar_ts - sweep_cam_ts) - (lidar_ts - cur_cam_ts)
        = mean(cur_cam_ts) - mean(sweep_cam_ts). When there are no
        sweeps the reference pads timestamps with
        mid(sweep_range) * 0.083 s (loading.py:96-97)."""
        sweeps = info.get("sweeps", [])
        if sweep_idx is None or not sweeps:
            lo, hi = self.sweep_range
            return (lo + hi) / 2.0 * 0.083
        sweep = sweeps[min(sweep_idx, len(sweeps) - 1)]
        if len(sweep.keys()) < len(CAM_ORDER):
            sweep = sweeps[min(sweep_idx, len(sweeps) - 1) - 1]
        cur = np.mean(
            [
                float(
                    info["cams"][cam].get("timestamp", info["timestamp"])
                )
                for cam in CAM_ORDER
            ]
        )
        swp = np.mean(
            [
                float(sweep[cam].get("timestamp", info["timestamp"]))
                for cam in CAM_ORDER
            ]
        )
        return float((cur - swp) / 1e6)

    def sweep_frame_calib(self, info, sweep_idx: int):
        """Paths + aligned lidar2img for one previous frame; falls back to
        duplicating the current frame when no sweeps exist
        (pad_empty_sweeps behavior, loading.py:92-102)."""
        sweeps = info.get("sweeps", [])
        if sweep_idx is None or not sweeps:
            return self.current_frame_calib(info)
        sweep = sweeps[min(sweep_idx, len(sweeps) - 1)]
        if len(sweep.keys()) < len(CAM_ORDER):
            sweep = sweeps[min(sweep_idx, len(sweeps) - 1) - 1]
        paths, mats = [], []
        for cam in CAM_ORDER:
            s = sweep[cam]
            c = info["cams"][cam]
            paths.append(s["data_path"])
            if "lidar2img" in s:
                # V2 sweep format: matrices precomputed offline
                # (LoadMultiViewImageFromMultiSweepsFiles_v2,
                # pipelines/loading.py:306)
                mats.append(np.asarray(s["lidar2img"], np.float64))
                continue
            mats.append(
                sweep_lidar2img(
                    c["cam_intrinsic"],
                    c["sensor2ego_rotation"],
                    c["sensor2ego_translation"],
                    s["ego2global_rotation"],
                    s["ego2global_translation"],
                    c["ego2global_rotation"],
                    c["ego2global_translation"],
                    info["lidar2ego_rotation"],
                    info["lidar2ego_translation"],
                )
            )
        return paths, np.asarray(mats, np.float32)

    # -- ground truth -----------------------------------------------------
    def padded_gt(self, info):
        boxes = np.asarray(info["gt_boxes"], np.float32).reshape(-1, 7)
        names = np.asarray(info["gt_names"]).reshape(-1)
        vel = np.asarray(
            info.get("gt_velocity", np.zeros((len(boxes), 2))), np.float32
        ).reshape(-1, 2)
        vel = np.nan_to_num(vel)
        if self.use_valid_flag and "valid_flag" in info:
            keep = np.asarray(info["valid_flag"], bool)
        else:
            keep = np.ones(len(boxes), bool)
        known = np.array(
            [n in NUSCENES_NAME_TO_LABEL for n in names], bool
        )
        keep = keep & known
        attrs = np.asarray(
            info.get("gt_attrs", [""] * len(boxes)), object
        ).reshape(-1)
        boxes, names, vel = boxes[keep], names[keep], vel[keep]
        attrs = attrs[keep[: len(attrs)]]
        labels = np.array(
            [NUSCENES_NAME_TO_LABEL[n] for n in names], np.int32
        )
        # z stays as stored: mmdet3d infos carry gravity-center z, and
        # the reference's bottom-center conversion (origin 0.5,0.5,0.5)
        # followed by training on .gravity_center is a net identity —
        # do NOT add an h/2 shift here (core/iou3d.py and the coder
        # assume gravity-center z)
        full = np.concatenate([boxes, vel], axis=1)  # (n, 9)

        G = self.max_gt
        n = min(len(full), G)
        gt_bboxes = np.zeros((G, 9), np.float32)
        gt_labels = np.zeros((G,), np.int32)
        gt_valid = np.zeros((G,), bool)
        gt_attrs = np.asarray([""] * G, object)
        gt_bboxes[:n] = full[:n]
        gt_labels[:n] = labels[:n]
        gt_valid[:n] = True
        gt_attrs[:n] = attrs[:n]
        return gt_bboxes, gt_labels, gt_valid, gt_attrs

    def sample(self, idx: int, temporal: bool = True) -> dict:
        info = self.infos[idx]
        paths, l2i = self.current_frame_calib(info)
        mts = None
        if temporal:
            sweep_idxs = self.choose_sweeps(info)
            for k in range(self.sweeps_num):
                sweep_idx = (
                    None if sweep_idxs is None else sweep_idxs[k]
                )
                spaths, sl2i = self.sweep_frame_calib(info, sweep_idx)
                paths = paths + spaths
                l2i = np.concatenate([l2i, sl2i], axis=0)
            # PETRv2 with_time uses frame 1 vs frame 0 only
            # (petrv2_head.py:493-494 time_stamp[:, 1] - time_stamp[:, 0])
            mts = self.mean_time_stamp(
                info, None if sweep_idxs is None else sweep_idxs[0]
            )
        gt_bboxes, gt_labels, gt_valid, gt_attrs = self.padded_gt(info)
        # per-camera intrinsics for the camera-aware (PECAM) head; sweep
        # frames reuse the current frame's intrinsics, exactly like the
        # sweep lidar2img composition above (loading.py:159-166 keys the
        # sweep projection on the current cams' cam_intrinsic)
        intr_cur = []
        for cam in CAM_ORDER:
            k4 = np.eye(4, dtype=np.float32)
            k = np.asarray(info["cams"][cam]["cam_intrinsic"], np.float32)
            k4[: k.shape[0], : k.shape[1]] = k
            intr_cur.append(k4)
        intr = np.asarray(intr_cur, np.float32)
        n_frames = l2i.shape[0] // len(CAM_ORDER)
        intr = np.tile(intr, (n_frames, 1, 1))
        # ego origin in the lidar frame (-R_l2e^T t_l2e): the devkit's
        # per-class eval range filter cuts on distance from the EGO, and
        # the lidar sits ~0.94 m from the ego center on nuScenes
        l2e_r = quaternion_to_rotation_matrix(
            np.asarray(info["lidar2ego_rotation"], np.float64)
        )
        l2e_t = np.asarray(info["lidar2ego_translation"], np.float64)
        ego_xy = (-(l2e_r.T @ l2e_t))[:2].astype(np.float32)
        out = {
            "token": info["token"],
            "image_paths": paths,
            "lidar2img": l2i,
            "intrinsics": intr,
            "ego_xy": ego_xy,
            "gt_bboxes": gt_bboxes,
            "gt_labels": gt_labels,
            "gt_valid": gt_valid,
            # attribute-name strings for AAE (host-side eval only; never
            # fed to jit)
            "gt_attrs": gt_attrs,
            "timestamp": info["timestamp"],
        }
        # segmentation variant: BEV map mask path rides along
        # (LoadMapsFromFiles parity, pipelines/loading.py:10-25)
        if "map_filename" in info:
            out["map_filename"] = info["map_filename"]
        if mts is not None:
            out["mean_time_stamp"] = mts
        return out


class CBGSDataset:
    """Class-balanced grouping-and-sampling wrapper (behavioral parity
    with mmdet3d's CBGSDataset, used by the reference's
    detr3d_res50.py:165): for every class, the samples containing it are
    re-drawn so each of the 10 classes contributes ~1/10 of the epoch's
    sample list. Wraps any dataset exposing `.infos` (with gt_names +
    valid_flag) and `.sample(idx)`."""

    def __init__(self, dataset, seed: int = 0):
        self.dataset = dataset
        rng = np.random.RandomState(seed)
        num_classes = len(NUSCENES_NAME_TO_LABEL)

        cat_to_ids = {c: [] for c in NUSCENES_NAME_TO_LABEL}
        for idx, info in enumerate(dataset.infos):
            names = np.asarray(info.get("gt_names", ())).reshape(-1)
            if "valid_flag" in info and getattr(
                dataset, "use_valid_flag", True
            ):
                keep = np.asarray(info["valid_flag"], bool)
                names = names[keep[: len(names)]]
            for c in set(str(n) for n in names):
                if c in cat_to_ids:
                    cat_to_ids[c].append(idx)

        duplicated = sum(len(v) for v in cat_to_ids.values())
        indices = []
        for ids in cat_to_ids.values():
            if not ids:
                continue
            frac = len(ids) / duplicated
            ratio = (1.0 / num_classes) / frac
            take = int(len(ids) * ratio)
            indices.extend(
                rng.choice(ids, take, replace=True).tolist()
            )
        # an empty annotation set degenerates to the identity epoch
        self.indices = indices or list(range(len(dataset)))

    def __len__(self):
        return len(self.indices)

    @property
    def infos(self):
        return self.dataset.infos

    def sample(self, idx: int, **kwargs) -> dict:
        return self.dataset.sample(self.indices[idx], **kwargs)
