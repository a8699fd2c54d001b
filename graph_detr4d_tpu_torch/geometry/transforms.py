"""Host-side (numpy) calibration composition
(counterpart of graph_detr4d_tpu/geometry/transforms.py).

These run in the input pipeline on the host and produce the dense
`lidar2img (N, 4, 4)` matrices the model consumes:

  * `lidar2img_from_calib`: the current frame
    (nuscenes_dataset.py:56-68, viewpad @ lidar2cam_rt.T);
  * `sweep_cam_to_current_lidar` / `sweep_lidar2img`: a previous frame's
    camera aligned to the current lidar through the two ego poses
    (loading.py:136-183).

Quaternions are (w, x, y, z); everything is float64.
"""

import numpy as np


def quaternion_to_rotation_matrix(q) -> np.ndarray:
    """(w, x, y, z) quaternion -> 3x3 rotation matrix (identity for a
    near-zero quaternion)."""
    w, x, y, z = np.asarray(q, dtype=np.float64)
    n = w * w + x * x + y * y + z * z
    if n < 1e-12:
        return np.eye(3)
    s = 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ]
    )


def _rt(R: np.ndarray, t) -> np.ndarray:
    """4x4 homogeneous transform p' = R @ p + t."""
    m = np.eye(4)
    m[:3, :3] = R
    m[:3, 3] = np.asarray(t, dtype=np.float64)
    return m


def lidar2img_from_calib(
    cam_intrinsic, sensor2lidar_rotation, sensor2lidar_translation
) -> np.ndarray:
    """(4, 4) float64 lidar -> image projection of one camera: K padded to
    4x4 times the inverse of the camera->lidar rigid transform
    (viewpad @ lidar2cam_rt.T of nuscenes_dataset.py:56-68)."""
    R_cl = np.asarray(sensor2lidar_rotation, dtype=np.float64)
    t_cl = np.asarray(sensor2lidar_translation, dtype=np.float64)
    lidar2cam = _rt(R_cl.T, -R_cl.T @ t_cl)
    viewpad = np.eye(4)
    K = np.asarray(cam_intrinsic, dtype=np.float64)
    viewpad[: K.shape[0], : K.shape[1]] = K
    return viewpad @ lidar2cam


def sweep_cam_to_current_lidar(
    cam2ego_rotation,
    cam2ego_translation,
    sweep_ego2global_rotation,
    sweep_ego2global_translation,
    cur_ego2global_rotation,
    cur_ego2global_translation,
    lidar2ego_rotation,
    lidar2ego_translation,
):
    """Sweep camera -> current lidar rigid transform (R (3, 3), t (3,)):

      cam->lidar_cur = (lidar2ego)^-1 (ego2global_cur)^-1
                       ego2global_sweep cam2ego

    with cam2ego the camera's fixed mounting (loading.py:154-166)."""
    cam2ego = _rt(quaternion_to_rotation_matrix(cam2ego_rotation),
                  cam2ego_translation)
    e2g_s = _rt(quaternion_to_rotation_matrix(sweep_ego2global_rotation),
                sweep_ego2global_translation)
    e2g_c = _rt(quaternion_to_rotation_matrix(cur_ego2global_rotation),
                cur_ego2global_translation)
    l2e = _rt(quaternion_to_rotation_matrix(lidar2ego_rotation),
              lidar2ego_translation)
    m = np.linalg.inv(l2e) @ np.linalg.inv(e2g_c) @ e2g_s @ cam2ego
    return m[:3, :3], m[:3, 3]


def sweep_lidar2img(
    cam_intrinsic,
    cam2ego_rotation,
    cam2ego_translation,
    sweep_ego2global_rotation,
    sweep_ego2global_translation,
    cur_ego2global_rotation,
    cur_ego2global_translation,
    lidar2ego_rotation,
    lidar2ego_translation,
) -> np.ndarray:
    """(4, 4) current lidar -> sweep image projection (loading.py:168-183)."""
    R, t = sweep_cam_to_current_lidar(
        cam2ego_rotation,
        cam2ego_translation,
        sweep_ego2global_rotation,
        sweep_ego2global_translation,
        cur_ego2global_rotation,
        cur_ego2global_translation,
        lidar2ego_rotation,
        lidar2ego_translation,
    )
    return lidar2img_from_calib(cam_intrinsic, R, t)


def quat_multiply(q1, q2) -> np.ndarray:
    """Hamilton product of (w, x, y, z) quaternions."""
    w1, x1, y1, z1 = np.asarray(q1, np.float64)
    w2, x2, y2, z2 = np.asarray(q2, np.float64)
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def quat_inverse(q) -> np.ndarray:
    """Inverse of a (w, x, y, z) quaternion (the conjugate over |q|^2)."""
    w, x, y, z = np.asarray(q, np.float64)
    n = w * w + x * x + y * y + z * z
    return np.array([w, -x, -y, -z]) / n


def quat_yaw(q) -> float:
    """Yaw (rotation about +z) of a (w, x, y, z) quaternion, the devkit
    Box's yaw_pitch_roll[0]."""
    w, x, y, z = np.asarray(q, np.float64)
    return float(np.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z)))
