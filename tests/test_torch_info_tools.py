"""The port's offline info generators (tools/create_data.py and
tools/generate_sweep_pkl.py under graph_detr4d_tpu_torch/) against the
JAX package's tools on a raw nuScenes JSON database built here (nuScenes
is not in the repository): a seeded rig of 4 key samples in 2 scenes,
6 cameras with 2 intermediate camera frames between key frames, rotated
sensors and ego poses, annotated instances spanning samples (velocities
by differentiation, one beyond the 1.5 s window), attributes, an
unmapped category and an annotation without points. The pickles must be
equal key for key, numpy arrays exactly (dtype, shape and values), for
every sample, for a scene-list subset, and for the sweep lists at two
depths.
"""

import importlib.util
import json
import os
import pickle
import sys

import numpy as np
import pytest

from graph_detr4d_tpu_torch.tools import create_data, generate_sweep_pkl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMS = create_data.CAMERA_TYPES


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quat(rng, yaw_only=False):
    if yaw_only:
        a = rng.uniform(-np.pi, np.pi)
        return [float(np.cos(a / 2)), 0.0, 0.0, float(np.sin(a / 2))]
    q = rng.randn(4)
    return (q / np.linalg.norm(q)).tolist()


def write_db(root, version="v1.0-mini", seed=0):
    """Raw tables of 4 key samples (scenes sc0: s0-s2, sc1: s3)."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, version))
    t = {n: [] for n in ("sample", "sample_data", "ego_pose",
                         "calibrated_sensor", "sample_annotation", "instance",
                         "category", "scene", "attribute")}
    t["scene"] = [{"token": "sc0", "name": "scene-0001"},
                  {"token": "sc1", "name": "scene-0002"}]
    t["category"] = [{"token": "c0", "name": "vehicle.car"},
                     {"token": "c1", "name": "human.pedestrian.adult"},
                     {"token": "c2", "name": "animal"}]
    t["attribute"] = [{"token": "at0", "name": "vehicle.moving"},
                      {"token": "at1", "name": "pedestrian.standing"}]
    t["calibrated_sensor"].append({
        "token": "cs_lidar", "translation": [0.9, 0.02, 1.8],
        "rotation": quat(rng, yaw_only=True), "camera_intrinsic": []})
    for i, cam in enumerate(CAMS):
        t["calibrated_sensor"].append({
            "token": f"cs_{cam}", "translation": rng.uniform(-2, 2, 3).tolist(),
            "rotation": quat(rng),
            "camera_intrinsic": [[1260.0 + i, 0.0, 800.0 + i],
                                 [0.0, 1260.0, 450.0], [0.0, 0.0, 1.0]]})
    pose_n = [0]

    def pose(ts):
        tok = f"pose{pose_n[0]}"
        pose_n[0] += 1
        t["ego_pose"].append({"token": tok, "timestamp": ts,
                              "rotation": quat(rng, yaw_only=True),
                              "translation": rng.uniform(-500, 500,
                                                         3).tolist()})
        return tok

    keys = [("s0", "sc0", 1_000_000), ("s1", "sc0", 1_500_000),
            ("s2", "sc0", 2_000_000), ("s3", "sc1", 9_000_000)]
    last = {cam: "" for cam in CAMS}
    for k, (tok, scene, ts) in enumerate(keys):
        prev = keys[k - 1][0] if k and keys[k - 1][1] == scene else ""
        nxt = (keys[k + 1][0] if k + 1 < len(keys)
               and keys[k + 1][1] == scene else "")
        data = {}
        sd_l = f"sd_lidar_{tok}"
        t["sample_data"].append({
            "token": sd_l, "sample_token": tok, "ego_pose_token": pose(ts),
            "calibrated_sensor_token": "cs_lidar", "timestamp": ts,
            "is_key_frame": True, "filename": f"samples/LIDAR_TOP/{tok}.bin",
            "channel": "LIDAR_TOP", "prev": "", "next": ""})
        data["LIDAR_TOP"] = sd_l
        for cam in CAMS:
            if prev:  # two camera frames between the key frames
                for j in range(2):
                    st = ts - (2 - j) * 160_000
                    sd = f"sd_{cam}_{tok}_{j}"
                    t["sample_data"].append({
                        "token": sd, "sample_token": prev,
                        "ego_pose_token": pose(st),
                        "calibrated_sensor_token": f"cs_{cam}",
                        "timestamp": st, "is_key_frame": False,
                        "filename": f"sweeps/{cam}/{sd}.jpg",
                        "channel": cam, "prev": last[cam], "next": ""})
                    last[cam] = sd
            elif k:
                last[cam] = ""  # a new scene
            sd = f"sd_{cam}_{tok}"
            t["sample_data"].append({
                "token": sd, "sample_token": tok,
                "ego_pose_token": pose(ts + 10),
                "calibrated_sensor_token": f"cs_{cam}", "timestamp": ts + 10,
                "is_key_frame": True, "filename": f"samples/{cam}/{sd}.jpg",
                "channel": cam, "prev": last[cam], "next": ""})
            last[cam] = sd
            data[cam] = sd
        t["sample"].append({"token": tok, "timestamp": ts, "prev": prev,
                            "next": nxt, "scene_token": scene, "data": data,
                            "anns": []})
    # instances: i0 a car through s0-s2 (velocity), i1 a pedestrian in
    # s0 and s2 only (1.0 s apart), i2 an unmapped animal without points,
    # i3 a car in s3 alone (no neighbour: nan velocity)
    tracks = {"i0": ("c0", ["s0", "s1", "s2"]), "i1": ("c1", ["s0", "s2"]),
              "i2": ("c2", ["s1"]), "i3": ("c0", ["s3"])}
    samples = {s["token"]: s for s in t["sample"]}
    for inst, (cat, toks) in tracks.items():
        t["instance"].append({"token": inst, "category_token": cat})
        anns = [f"a_{inst}_{s}" for s in toks]
        for j, (a, s) in enumerate(zip(anns, toks)):
            t["sample_annotation"].append({
                "token": a, "sample_token": s, "instance_token": inst,
                "translation": rng.uniform(-60, 60, 3).tolist(),
                "size": rng.uniform(0.5, 5, 3).tolist(),
                "rotation": quat(rng, yaw_only=True),
                "num_lidar_pts": 0 if inst == "i2" else int(rng.randint(1, 50)),
                "num_radar_pts": 0 if inst == "i2" else int(rng.randint(0, 5)),
                "attribute_tokens": [] if inst == "i2" else
                [("at0", "at1")[cat == "c1"]],
                "prev": anns[j - 1] if j else "",
                "next": anns[j + 1] if j + 1 < len(anns) else ""})
            samples[s]["anns"].append(a)
    for name, rows in t.items():
        with open(os.path.join(root, version, f"{name}.json"), "w") as f:
            json.dump(rows, f)
    return version


def assert_same(a, b, where="infos"):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    else:
        assert a == b or (a != a and b != b), where


def run_jax_main(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__name__, *argv])
    mod.main()


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc_raw"))
    return root, write_db(root)


@pytest.mark.parametrize("scenes", [None, ["scene-0001"]])
def test_create_data_matches_jax_tool(db, tmp_path, monkeypatch, scenes):
    root, version = db
    argv = ["--data-root", root, "--version", version]
    if scenes:
        with open(tmp_path / "scenes.txt", "w") as f:
            f.write("\n".join(scenes) + "\n")
        argv += ["--scene-list", str(tmp_path / "scenes.txt")]
    run_jax_main(jax_tool("create_data"), argv + ["--out", str(tmp_path / "j.pkl")],
                 monkeypatch)
    create_data.main(argv + ["--out", str(tmp_path / "p.pkl")])
    want, got = load(tmp_path / "j.pkl"), load(tmp_path / "p.pkl")
    assert len(got["infos"]) == (3 if scenes else 4)
    assert any(len(i.get("gt_names", [])) for i in got["infos"])
    assert_same(got, want)


@pytest.mark.parametrize("num_prev,num_sweep", [(1, 1), (2, 3)])
def test_generate_sweep_pkl_matches_jax_tool(db, tmp_path, monkeypatch,
                                             num_prev, num_sweep):
    root, version = db
    infos = str(tmp_path / "infos.pkl")
    create_data.main(["--data-root", root, "--version", version, "--out",
                      infos])
    common = ["--data-root", root, "--info-pkl", infos, "--version", version,
              "--num-prev", str(num_prev), "--num-sweep", str(num_sweep)]
    run_jax_main(jax_tool("generate_sweep_pkl"),
                 common + ["--out", str(tmp_path / "j.pkl")], monkeypatch)
    generate_sweep_pkl.main(common + ["--out", str(tmp_path / "p.pkl")])
    want, got = load(tmp_path / "j.pkl"), load(tmp_path / "p.pkl")
    assert max(len(i["sweeps"]) for i in got["infos"]) > 0
    assert_same(got, want)
