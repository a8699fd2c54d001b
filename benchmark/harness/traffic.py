"""The serving driver's traffic generator (drivers/serve.py): a traffic
file's parameters, a configuration and a seed make every request of a
run.

A traffic file (`benchmark/traffic/<name>.json`) with "driver": "serve"
names the program's entry and its parameters:

  entry           "infer_stream" (Engine.infer_stream: the new frame's
                  cameras, the previous frame's features from the
                  stream's cache) or "infer" (Engine.infer: the whole
                  rig, stateless)
  pool_frames     frames made before the window and cycled through
  scene_frames    (infer_stream) requests a scene; the stream is reset
                  before each scene's first request, which then has no
                  cached frame
  warmup_requests requests of the mix run in set-up, before the window
  check_requests  requests compared with the reference after the window
  feature_window  the first requests among which the benchmark keeps the
                  head's input (the backbone's and neck's output, and the
                  cached frame's) of `feature_requests`
  trace_requests  requests in each traced window of a --trace 1 run

Every seed gives the same sizes and arrivals: one car, one client, batch
1, each request sent as soon as the last is answered (closed loop). The
seed draws the images (float32, normalised, N(0, 0.25), on the device in
one call), each frame's rig (a nuScenes-like surround rig whose heading
and previous-keyframe offset vary by frame) and where in the pool the
window starts.
"""

import math

import numpy as np
import torch

STREAM = "car-0"
IMAGES_SALT = 0x9E3779B97F4A7C15


def lidar2img_from_calib(K, R_cl, t_cl):
    """(4, 4) lidar -> image: K padded to 4 x 4 times the inverse of the
    camera -> lidar rigid transform."""
    lidar2cam = np.eye(4)
    lidar2cam[:3, :3] = R_cl.T
    lidar2cam[:3, 3] = -R_cl.T @ t_cl
    viewpad = np.eye(4)
    viewpad[:3, :3] = K
    return viewpad @ lidar2cam


def surround_rig(num_cams, frame_cams, img_hw, rng):
    """(num_cams, 4, 4) lidar2img of one frame: frame_cams cameras at equal
    yaw steps from a seeded heading, 1.5 m ahead of and 1.6 m above the
    lidar, focal 0.65 W; cameras past frame_cams are the previous
    keyframe's, about 2 m behind (as the program's data/synthetic.py
    builds its rig, with the heading and the offset drawn per frame)."""
    H, W = img_hw
    heading = rng.uniform(-0.1, 0.1)
    back = np.array([-2.0, 0.0, 0.0]) + rng.normal(0.0, [0.2, 0.05, 0.02])
    K = np.array([[0.65 * W, 0.0, W / 2], [0.0, 0.65 * W, H / 2], [0.0, 0.0, 1.0]])
    cam_axes = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    mats = []
    for n in range(num_cams):
        yaw = 2 * math.pi * (n % frame_cams) / frame_cams + heading
        c, s = math.cos(yaw), math.sin(yaw)
        R_yaw = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        R_cl = (cam_axes @ R_yaw.T).T
        t_cl = R_yaw @ np.array([1.5, 0.0, 1.6])
        if n >= frame_cams:
            t_cl = t_cl + back
        mats.append(lidar2img_from_calib(K, R_cl, t_cl))
    return np.asarray(mats, np.float32)


class Traffic:
    """The requests of one run: request i is pool frame `frame(i)`, sent by
    `call(engine, i, extras)`."""

    def __init__(self, spec: dict, model: dict, extra_values: dict, seed: int,
                 device):
        self.spec = spec
        self.entry = spec["entry"]
        if self.entry not in ("infer_stream", "infer"):
            raise ValueError(f"unknown entry {self.entry!r}")
        h = model["head"]
        self.frame_cams, self.num_cams = h["num_frame_cams"], h["num_cams"]
        H, W = model["img_size"]
        self.pool = spec["pool_frames"]
        gen = torch.Generator(device=device)
        gen.manual_seed((seed + IMAGES_SALT) % 2 ** 64)  # apart from the weights
        frames = torch.randn(self.pool, self.frame_cams, H, W, 3, generator=gen,
                             device=device) * 0.5
        self.frames = frames.cpu().numpy()
        rng = np.random.default_rng([seed, 1])
        self.rigs = np.stack([surround_rig(self.num_cams, self.frame_cams, (H, W),
                                           rng) for _ in range(self.pool)])
        self.start = int(rng.integers(self.pool))
        if self.entry == "infer":
            self.rig_images = [np.concatenate(
                [self.frames[p], self.frames[self.previous(p)]])[None]
                for p in range(self.pool)]
        self.extra_values = extra_values

    def previous(self, p: int) -> int:
        return (p - 1) % self.pool

    def frame(self, i: int) -> int:
        return (self.start + i) % self.pool

    def starts_scene(self, i: int) -> bool:
        return self.entry == "infer_stream" and i % self.spec["scene_frames"] == 0

    def reset(self, engine):
        """The car's stream emptied, as before a scene (after set-up)."""
        if self.entry == "infer_stream":
            engine.reset_stream(STREAM)

    def extras(self, spec):
        """The values of the Engine's extras_spec [(name, shape)]."""
        return [np.full(shape, self.extra_values[name], np.float32)
                for name, shape in spec]

    def images(self, i: int):
        p = self.frame(i)
        if self.entry == "infer":
            return self.rig_images[p]
        return self.frames[p][None]

    def lidar2img(self, i: int):
        return self.rigs[self.frame(i)][None]

    def call(self, engine, i: int, extras):
        """Send request i (resetting the stream at a scene's start); the
        numpy answer."""
        if self.entry == "infer":
            return engine.infer(self.images(i), self.lidar2img(i), extras)
        if self.starts_scene(i):
            engine.reset_stream(STREAM)
        return engine.infer_stream(self.images(i), self.lidar2img(i), extras,
                                   stream=STREAM)
