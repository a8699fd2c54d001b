"""Base nuScenes infos generator (counterpart of tools/create_data.py;
reference: tools/create_data.py + tools/data_converter/
nuscenes_converter.py:144-278) — re-implemented over the raw nuScenes
JSON tables with NO nuscenes-devkit / mmdet3d dependency.

Produces the exact info layout the reference pipeline (and this
framework's NuScenesSweepDataset / generate_sweep_pkl.py) consumes:

  info = {token, timestamp, lidar_path, lidar2ego_*, ego2global_*,
          cams: {CAM: {data_path, cam_intrinsic, sensor2ego_*,
                       sensor2lidar_rotation/translation, ego2global_*,
                       timestamp}},
          gt_boxes (M, 7 SECOND convention: x y z w l h -yaw-pi/2, lidar
          frame), gt_names (detection classes via the standard
          NameMapping), gt_velocity (M, 2, lidar frame), num_lidar_pts,
          num_radar_pts, valid_flag, sweeps: []}

  python -m graph_detr4d_tpu_torch.tools.create_data \
      --data-root data/nuscenes --version v1.0-trainval \
      --out data/nuscenes/nuscenes_infos_train.pkl \
      [--scene-list scenes.txt]   # optional subset filter (train/val split)

The pickle is the one the JAX tool writes, key for key.
"""

import argparse
import json
import os
import pickle

import numpy as np

from ..geometry.transforms import (
    quat_inverse,
    quat_multiply,
    quat_yaw,
    quaternion_to_rotation_matrix,
)

CAMERA_TYPES = (
    "CAM_FRONT",
    "CAM_FRONT_RIGHT",
    "CAM_FRONT_LEFT",
    "CAM_BACK",
    "CAM_BACK_LEFT",
    "CAM_BACK_RIGHT",
)

# the standard mmdet3d/nuScenes detection-class mapping
NAME_MAPPING = {
    "movable_object.barrier": "barrier",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}


def load_tables(data_root, version, names):
    tables = {}
    for n in names:
        with open(os.path.join(data_root, version, f"{n}.json")) as f:
            rows = json.load(f)
        tables[n] = {r["token"]: r for r in rows}
    return tables


def sensor2top(sd, tables, l2e_t, l2e_r, e2g_t, e2g_r, data_root):
    """sensor -> current-frame-lidar rigid transform
    (nuscenes_converter.py obtain_sensor2top:280-340): chain
    sensor2ego(sweep) -> ego2global(sweep) -> global2ego(cur) ->
    ego2lidar(cur)."""
    cs = tables["calibrated_sensor"][sd["calibrated_sensor_token"]]
    pose = tables["ego_pose"][sd["ego_pose_token"]]
    l2e_r_mat = quaternion_to_rotation_matrix(l2e_r)
    e2g_r_mat = quaternion_to_rotation_matrix(e2g_r)
    l2e_r_s_mat = quaternion_to_rotation_matrix(cs["rotation"])
    e2g_r_s_mat = quaternion_to_rotation_matrix(pose["rotation"])
    l2e_t = np.asarray(l2e_t)
    e2g_t = np.asarray(e2g_t)
    l2e_t_s = np.asarray(cs["translation"])
    e2g_t_s = np.asarray(pose["translation"])

    # the reference's row-vector formulation (:321-332), kept verbatim in
    # math (points @ R.T + T)
    R = (l2e_r_s_mat.T @ e2g_r_s_mat.T) @ (
        np.linalg.inv(e2g_r_mat).T @ np.linalg.inv(l2e_r_mat).T
    )
    T = (l2e_t_s @ e2g_r_s_mat.T + e2g_t_s) @ (
        np.linalg.inv(e2g_r_mat).T @ np.linalg.inv(l2e_r_mat).T
    )
    T -= (
        e2g_t @ (np.linalg.inv(e2g_r_mat).T @ np.linalg.inv(l2e_r_mat).T)
        + l2e_t @ np.linalg.inv(l2e_r_mat).T
    )
    info = {
        "data_path": os.path.join(data_root, sd["filename"]),
        "type": sd.get("channel", ""),
        "sample_data_token": sd["token"],
        "sensor2ego_translation": cs["translation"],
        "sensor2ego_rotation": cs["rotation"],
        "ego2global_translation": pose["translation"],
        "ego2global_rotation": pose["rotation"],
        "timestamp": sd["timestamp"],
        "sensor2lidar_rotation": R.T,  # points @ R.T + T
        "sensor2lidar_translation": T,
    }
    return info


def box_to_lidar(ann, l2e_t, l2e_r, e2g_t, e2g_r):
    """Global-frame annotation -> lidar-frame (center, wlh, yaw)."""
    c = np.asarray(ann["translation"], np.float64)
    q = np.asarray(ann["rotation"], np.float64)
    # global -> ego
    e2g_r_inv = quat_inverse(e2g_r)
    c = quaternion_to_rotation_matrix(e2g_r_inv) @ (c - np.asarray(e2g_t))
    q = quat_multiply(e2g_r_inv, q)
    # ego -> lidar
    l2e_r_inv = quat_inverse(l2e_r)
    c = quaternion_to_rotation_matrix(l2e_r_inv) @ (c - np.asarray(l2e_t))
    q = quat_multiply(l2e_r_inv, q)
    return c, np.asarray(ann["size"], np.float64), quat_yaw(q)


def ann_velocity(ann, tables, max_time_diff=1.5):
    """Global-frame xy velocity by position differentiation between the
    neighbouring annotations of the same instance (devkit box_velocity)."""
    sa = tables["sample_annotation"]
    sample = tables["sample"]
    has_prev = ann["prev"] != ""
    has_next = ann["next"] != ""
    if not has_prev and not has_next:
        return np.array([np.nan, np.nan])
    first = sa[ann["prev"]] if has_prev else ann
    last = sa[ann["next"]] if has_next else ann
    pos_first = np.asarray(first["translation"])
    pos_last = np.asarray(last["translation"])
    t_first = sample[first["sample_token"]]["timestamp"] / 1e6
    t_last = sample[last["sample_token"]]["timestamp"] / 1e6
    dt = t_last - t_first
    if dt > max_time_diff or dt <= 0:
        return np.array([np.nan, np.nan])
    return ((pos_last - pos_first) / dt)[:2]


def build_info(sample, tables, data_root):
    sd_lidar = tables["sample_data"][sample["data"]["LIDAR_TOP"]]
    cs = tables["calibrated_sensor"][sd_lidar["calibrated_sensor_token"]]
    pose = tables["ego_pose"][sd_lidar["ego_pose_token"]]
    l2e_t, l2e_r = cs["translation"], cs["rotation"]
    e2g_t, e2g_r = pose["translation"], pose["rotation"]

    info = {
        "lidar_token": sample["data"]["LIDAR_TOP"],
        "lidar_path": os.path.join(data_root, sd_lidar["filename"]),
        "token": sample["token"],
        "sweeps": [],
        "cams": {},
        "lidar2ego_translation": l2e_t,
        "lidar2ego_rotation": l2e_r,
        "ego2global_translation": e2g_t,
        "ego2global_rotation": e2g_r,
        "timestamp": sample["timestamp"],
    }
    for cam in CAMERA_TYPES:
        sd = tables["sample_data"][sample["data"][cam]]
        cam_info = sensor2top(
            sd, tables, l2e_t, l2e_r, e2g_t, e2g_r, data_root
        )
        K = tables["calibrated_sensor"][sd["calibrated_sensor_token"]][
            "camera_intrinsic"
        ]
        cam_info["cam_intrinsic"] = np.asarray(K, np.float64)
        info["cams"][cam] = cam_info

    # annotations
    anns = [tables["sample_annotation"][t] for t in sample["anns"]]
    if anns:
        e2g_r_mat = quaternion_to_rotation_matrix(e2g_r)
        l2e_r_mat = quaternion_to_rotation_matrix(l2e_r)
        locs, dims, rots, names, vels, nlp, nrp = [], [], [], [], [], [], []
        attrs = []
        attr_table = tables.get("attribute", {})
        for ann in anns:
            # attribute name ('' when the annotation carries none) — the
            # devkit's AAE ground truth (eval/nuscenes_metrics.py)
            atoks = ann.get("attribute_tokens", [])
            attrs.append(
                attr_table.get(atoks[0], {}).get("name", "")
                if atoks
                else ""
            )
            c, wlh, yaw = box_to_lidar(ann, l2e_t, l2e_r, e2g_t, e2g_r)
            locs.append(c)
            dims.append(wlh)
            rots.append(yaw)
            inst = tables["instance"][ann["instance_token"]]
            cat = tables["category"][inst["category_token"]]["name"]
            names.append(NAME_MAPPING.get(cat, cat))
            v = ann_velocity(ann, tables)
            v3 = np.array([*np.nan_to_num(v), 0.0])
            v3 = v3 @ np.linalg.inv(e2g_r_mat).T @ np.linalg.inv(
                l2e_r_mat
            ).T  # global -> lidar (:251-255)
            vels.append(v3[:2])
            nlp.append(ann.get("num_lidar_pts", 0))
            nrp.append(ann.get("num_radar_pts", 0))
        locs = np.asarray(locs).reshape(-1, 3)
        dims = np.asarray(dims).reshape(-1, 3)
        rots = np.asarray(rots).reshape(-1, 1)
        # SECOND yaw convention (:258)
        info["gt_boxes"] = np.concatenate(
            [locs, dims, -rots - np.pi / 2], axis=1
        )
        info["gt_names"] = np.asarray(names)
        info["gt_attrs"] = np.asarray(attrs, object)
        info["gt_velocity"] = np.asarray(vels).reshape(-1, 2)
        info["num_lidar_pts"] = np.asarray(nlp)
        info["num_radar_pts"] = np.asarray(nrp)
        info["valid_flag"] = (
            info["num_lidar_pts"] + info["num_radar_pts"]
        ) > 0
    return info


def main(argv=None):
    p = argparse.ArgumentParser(prog="graph_detr4d_tpu_torch.tools.create_data")
    p.add_argument("--data-root", required=True)
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--out", required=True)
    p.add_argument(
        "--scene-list",
        default=None,
        help="optional file with one scene name per line (split filter)",
    )
    args = p.parse_args(argv)

    tables = load_tables(
        args.data_root,
        args.version,
        (
            "sample",
            "sample_data",
            "ego_pose",
            "calibrated_sensor",
            "sample_annotation",
            "instance",
            "category",
            "scene",
            "attribute",
        ),
    )
    keep_scenes = None
    if args.scene_list:
        with open(args.scene_list) as f:
            names = {line.strip() for line in f if line.strip()}
        keep_scenes = {
            t for t, s in tables["scene"].items() if s["name"] in names
        }

    infos = []
    samples = sorted(
        tables["sample"].values(), key=lambda s: s["timestamp"]
    )
    for i, sample in enumerate(samples):
        if keep_scenes is not None and sample["scene_token"] not in keep_scenes:
            continue
        infos.append(build_info(sample, tables, args.data_root))
        if (i + 1) % 1000 == 0:
            print(f"{i + 1}/{len(samples)}")

    with open(args.out, "wb") as f:
        pickle.dump(
            {"infos": infos, "metadata": {"version": args.version}}, f
        )
    print(f"wrote {len(infos)} infos to {args.out}")


if __name__ == "__main__":
    main()
