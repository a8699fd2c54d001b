"""Offline temporal-sweep index generator (counterpart of
tools/generate_sweep_pkl.py; reference: tools/generate_sweep_pkl.py:1-123).

Walks the nuScenes DB backwards from each key frame and attaches
`num_prev` previous key frames x `num_sweep` inter-key camera frames to
`infos[i]['sweeps']`, each entry a per-camera dict with `data_path`,
`timestamp`, `ego2global_rotation/translation` — exactly the layout
LoadMultiViewImageFromMultiSweepsFiles (and our
NuScenesSweepDataset.sweep_frame_calib) consumes.

No nuscenes-devkit dependency: the devkit's `get()` is a dict lookup over
the raw JSON tables (sample.json, sample_data.json, ego_pose.json), loaded
directly here.

  python -m graph_detr4d_tpu_torch.tools.generate_sweep_pkl \
      --data-root data/nuscenes \
      --info-pkl data/nuscenes/nuscenes_infos_train.pkl \
      --out data/nuscenes/mmdet3d_nuscenes_30f_infos_train.pkl \
      [--version v1.0-trainval] [--num-prev 5] [--num-sweep 5]

The pickle is the one the JAX tool writes, key for key.
"""

import argparse
import json
import os
import pickle

CAMS = (
    "CAM_FRONT",
    "CAM_FRONT_RIGHT",
    "CAM_BACK_RIGHT",
    "CAM_BACK",
    "CAM_BACK_LEFT",
    "CAM_FRONT_LEFT",
)


def load_table(data_root: str, version: str, name: str) -> dict:
    path = os.path.join(data_root, version, f"{name}.json")
    with open(path) as f:
        rows = json.load(f)
    return {r["token"]: r for r in rows}


def build_sweeps(
    info: dict,
    tables: dict,
    data_root: str,
    num_prev: int,
    num_sweep: int,
) -> list:
    """Sweep list for one key-frame info (reference :86-122): for each of
    `num_prev` steps back, `num_sweep` inter-key camera frames then the
    previous key frame itself, all per-camera with ego poses."""
    sample_t = tables["sample"]
    sdata_t = tables["sample_data"]
    pose_t = tables["ego_pose"]

    def frame_entry(sd: dict) -> dict:
        pose = pose_t[sd["ego_pose_token"]]
        return {
            "is_key_frame": sd["is_key_frame"],
            "data_path": os.path.join(data_root, sd["filename"]),
            "type": "camera",
            "timestamp": sd["timestamp"],
            "sample_data_token": sd["sample_token"],
            "ego2global_translation": pose["translation"],
            "ego2global_rotation": pose["rotation"],
        }

    sample = sample_t[info["token"]]
    current = {c: sdata_t[sample["data"][c]] for c in CAMS}

    sweep_lists = []
    for _ in range(num_prev):
        if sample["prev"] == "":
            break
        for _ in range(num_sweep):
            sweep_cams = {}
            broke = False
            for cam in CAMS:
                if current[cam]["prev"] == "":
                    # reference behavior (:108-110): reuse the last sweep
                    sweep_cams = sweep_lists[-1]
                    broke = True
                    break
                sd = sdata_t[current[cam]["prev"]]
                sweep_cams[cam] = frame_entry(sd)
                current[cam] = sd
            sweep_lists.append(sweep_cams)
            if broke:
                continue
        sample = sample_t[sample["prev"]]
        sweep_cams = {}
        for cam in CAMS:
            sd = sdata_t[sample["data"][cam]]
            sweep_cams[cam] = frame_entry(sd)
            current[cam] = sd
        sweep_lists.append(sweep_cams)
    return sweep_lists


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="graph_detr4d_tpu_torch.tools.generate_sweep_pkl")
    p.add_argument("--data-root", required=True)
    p.add_argument("--info-pkl", required=True, help="base infos pkl")
    p.add_argument("--out", required=True)
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--num-prev", type=int, default=5)
    p.add_argument("--num-sweep", type=int, default=5)
    args = p.parse_args(argv)

    with open(args.info_pkl, "rb") as f:
        key_infos = pickle.load(f)

    tables = {
        name: load_table(args.data_root, args.version, name)
        for name in ("sample", "sample_data", "ego_pose")
    }

    infos = key_infos["infos"]
    for i, info in enumerate(infos):
        info["sweeps"] = build_sweeps(
            info, tables, args.data_root, args.num_prev, args.num_sweep
        )
        if (i + 1) % 500 == 0:
            print(f"{i + 1}/{len(infos)}")

    with open(args.out, "wb") as f:
        pickle.dump(key_infos, f)
    print(f"wrote {len(infos)} infos with sweeps to {args.out}")


if __name__ == "__main__":
    main()
