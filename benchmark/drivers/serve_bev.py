"""The serving driver of BEVFormer (configuration `bevformer`): one car's
scenes through serve.Engine.infer_stream, each request the frame's 6
cameras and its absolute `can_bus` from a seeded ego path, the previous
BEV from the Engine's stream cache; drivers/serve.py's warm-up, requests
and closed loop, harness/traffic.py's images and rigs (wrapped here, not
edited).

A traffic file names it with "driver": "serve_bev" and holds
harness/traffic.py's parameters (`entry` "infer_stream") and these:

  check_window  the first requests among which the check's sample is
                drawn, before the window: request 0 (a scene's first,
                no previous BEV) and check_requests - 1 others
  chain_frames  the first frames of the window's first scene whose BEV
                the reference works out again from its own previous one
  image_rows    the rows of the camera image; the rows below, up to the
                network's padded height, are zero, as the published
                pipeline pads them
  keyframe_s, max_speed_mps, max_yaw_rate
                the ego path: each scene starts at a seeded position and
                heading and moves keyframe by keyframe at a seeded speed
                in [0, max_speed_mps] and yaw rate in [-max_yaw_rate,
                max_yaw_rate] rad/s

The check compares what the window produced with the plain float32
reference (reference/bevformer.py), nothing of the program's entering the
reference but where a number says so. Numbers, each the worst over its
sample (harness/check.py's `rel`):

  overflow   in-view BEV queries SCA's capacity dropped, summed over the
             window's requests (exact: 0)
  answer     the served answer against the reference decode of the
             head's own last layer (exact)
  features   each level of the backbone and neck's output, of the
             feature-sampled requests
  bev        the encoder's output of each sampled request against the
             reference's on the same images and motion with the
             program's own previous BEV (its output of the request
             before, captured in the window) as the previous BEV: state
             the program prepared, so the number holds one frame's
             encoder, the rotation and the shift to account
  bev_chain  the program's BEV of the first scene's frame chain_frames
             against the reference's, which runs from the scene's first
             frame on its own previous BEVs: the drift through the
             recurrence
  logits     each decoder layer's class logits of the sampled requests
             against the reference decoder's over the reference's BEV of
             `bev`
  boxes      the same of the box codes

The motion the reference reads is worked out here from the traffic's
absolute can_bus, as the published test loop does, not taken from the
Engine.
"""

import gc
import math

import numpy as np
import torch

import reference
from drivers.serve import feature_sample, send, warm  # noqa: F401  (the API)
from harness.cell import closed_loop
from harness.check import rel, served_gap
from harness.traffic import STREAM, Traffic
from harness.weights import make_state_dict
from reference.common import Ref, strict_float32

PATH_SALT = 7
CAN_YAW_RAD, CAN_YAW_DEG = 16, 17


def ego_path(seed, scene, frames, spec):
    """(frames, 18) float32 absolute can_bus of one scene: position (x, y,
    z), orientation quaternion, acceleration, rotation rate, velocity,
    two zeros, then the yaw in radians and in degrees in [0, 360), as the
    published nuScenes converter fills them."""
    rng = np.random.default_rng([seed, PATH_SALT, scene])
    dt = spec["keyframe_s"]
    x, y = rng.uniform(300.0, 2000.0, 2)
    yaw = rng.uniform(0.0, 2 * math.pi)
    out = np.zeros((frames, 18), np.float64)
    for k in range(frames):
        v = rng.uniform(0.0, spec["max_speed_mps"])
        w = rng.uniform(-spec["max_yaw_rate"], spec["max_yaw_rate"])
        deg = math.degrees(yaw) % 360.0
        out[k, 0:3] = x, y, 0.0
        out[k, 3:7] = math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)
        out[k, 7:10] = rng.normal(0.0, 0.5, 3)
        out[k, 10:13] = 0.0, 0.0, w
        out[k, 13:16] = v, 0.0, 0.0
        out[k, CAN_YAW_RAD] = deg / 180 * math.pi
        out[k, CAN_YAW_DEG] = deg
        x += v * dt * math.cos(yaw)
        y += v * dt * math.sin(yaw)
        yaw += w * dt
    return out.astype(np.float32)


class BEVTraffic(Traffic):
    """harness/traffic.py's requests with BEVFormer's can_bus: request i
    is pool frame `frame(i)` with the absolute can_bus of frame i %
    scene_frames of its scene's ego path; the pad rows of every image
    are zero."""

    def __init__(self, spec, model, seed, device):
        super().__init__(spec, model, {}, seed, device)
        self.seed = seed
        self.frames[:, :, spec["image_rows"]:] = 0.0
        self._paths = {}

    def can_bus(self, i: int):
        scene, k = divmod(i, self.spec["scene_frames"])
        if scene not in self._paths:
            self._paths[scene] = ego_path(self.seed, scene,
                                          self.spec["scene_frames"], self.spec)
        return self._paths[scene][k][None]

    def motion(self, i: int):
        """(1, 18) the can_bus of request i as the model reads it: its
        translation and yaw in degrees less request i - 1's (zero at a
        scene's first request), as the published test loop makes it."""
        can = self.can_bus(i).astype(np.float64)
        if self.starts_scene(i):
            can[:, 0:3] = 0.0
            can[:, CAN_YAW_DEG] = 0.0
        else:
            prev = self.can_bus(i - 1).astype(np.float64)
            can[:, 0:3] -= prev[:, 0:3]
            can[:, CAN_YAW_DEG] -= prev[:, CAN_YAW_DEG]
        return can.astype(np.float32)

    def call(self, engine, i: int, extras=None):
        if self.starts_scene(i):
            engine.reset_stream(STREAM)
        return engine.infer_stream(self.images(i), self.lidar2img(i),
                                   [self.can_bus(i)], stream=STREAM)


def setup(run):
    from graph_detr4d_tpu_torch.serve import Engine

    run.ref_mod = reference.load(run.config["reference"])
    run.sd = make_state_dict(run.ref_mod.param_specs(run.model_dict),
                             run.seed % 2 ** 64, run.device)
    run.engine = (run.program or Engine)(run.cfg, run.sd, device=run.device)
    run.model = run.engine.model
    run.traffic = BEVTraffic(run.traffic_spec, run.model_dict, run.seed,
                             run.device)
    run.extras = None
    run.capture = None


def check_sample(spec, seed):
    """The requests whose head output, BEV and answer the check compares,
    drawn from the seed before the window: request 0 and others among
    the first check_window."""
    rng = np.random.default_rng([seed, 3])
    rest = rng.choice(np.arange(1, spec["check_window"]),
                      spec["check_requests"] - 1, replace=False)
    return sorted({0} | {int(i) for i in rest})


def bev_kept(spec, picks):
    """The requests whose BEV the window keeps: the sample, the request
    before each (its previous BEV) and the chain's last frame."""
    scene = spec["scene_frames"]
    keep = set(picks) | {spec["chain_frames"] - 1}
    keep |= {i - 1 for i in picks if i % scene}
    return keep


class Capture:
    """Hooks on the model's head that keep what the window produced for
    the check: the head's input of the feature sample, the head's
    outputs and answers of the check's sample, the BEV of `bevs`, and
    every request's overflow."""

    def __init__(self, model, features, picks, bevs):
        self.index = -1
        self.features, self.heads, self.answers, self.bevs = {}, {}, {}, {}
        self.overflow = 0.0
        self.feature_sample, self.picks, self.keep = set(features), set(picks), set(bevs)
        head = model.pts_bbox_head
        self.handles = [head.register_forward_pre_hook(self._head_input),
                        head.register_forward_hook(self._head)]

    def _head_input(self, module, args):
        if self.index in self.feature_sample:
            self.features[self.index] = list(args[0])

    def _head(self, module, args, out):
        if self.index in self.picks:
            self.heads[self.index] = (out["all_cls_scores"], out["all_bbox_preds"])
        if self.index in self.keep:
            self.bevs[self.index] = out["bev_embed"]

    def answer(self, i, answer):
        if i in self.picks:
            self.answers[i] = answer
        self.overflow += float(answer["cam_overflow"])

    def close(self):
        for h in self.handles:
            h.remove()
        self.index = -1


def window(run, seconds):
    spec = run.traffic_spec
    run.picks = check_sample(spec, run.seed)
    run.capture = Capture(run.model, feature_sample(spec, run.seed), run.picks,
                          bev_kept(spec, run.picks))
    closed_loop(run, seconds)
    run.capture.close()
    run.captured, run.capture = run.capture, None
    return {"frames_per_s": run.requests / run.window_s}


class BEVReference:
    """The reference over a run's requests: a pool frame's features once,
    a request's (bev, cls, box) from a given previous BEV, and the chain
    of a scene's first frames on the reference's own BEVs."""

    def __init__(self, ref_mod, model, sd, traffic, precision="fp32"):
        self.mod, self.model, self.traffic = ref_mod, model, traffic
        self.ref = Ref(sd, precision)
        self.device = next(iter(sd.values())).device
        self._feats = {}

    def feats(self, i: int):
        p = self.traffic.frame(i)
        if p not in self._feats:
            images = torch.as_tensor(self.traffic.frames[p][None], device=self.device)
            self._feats[p] = self.mod.features(self.ref, self.model, images)
        return self._feats[p]

    def request(self, i: int, prev_bev):
        t = self.traffic
        l2i = torch.as_tensor(t.lidar2img(i), device=self.device)
        can = torch.as_tensor(t.motion(i), device=self.device)
        prev = None if prev_bev is None else prev_bev.float()
        return self.mod.bev_forward(self.ref, self.model, self.feats(i), l2i,
                                    can, prev)

    def chain(self, last: int, keep=None):
        """The reference's own BEV of request `last`, run from request 0
        (a scene's first) on its own previous BEVs; keep(i, bev, cls,
        box) is handed each request's output."""
        bev = None
        for i in range(last + 1):
            bev, cls, box = self.request(i, None if self.traffic.starts_scene(i)
                                         else bev)
            if keep is not None:
                keep(i, bev, cls, box)
        return bev


def program_side(capture, picks):
    return {"overflow": capture.overflow, "features": capture.features,
            "heads": {i: capture.heads[i] for i in picks},
            "answers": {i: capture.answers[i] for i in picks},
            "bevs": capture.bevs}


def compare(program, ref_run, picks, chain_last, coder, answers=True):
    """The numbers of the module's docstring: `program` {'overflow',
    'features' {i: levels}, 'heads' {i: (cls, box)}, 'answers' {i:
    answer}, 'bevs' {i: (1, H * W, C)}} against BEVReference ref_run."""
    t = ref_run.traffic
    out = {"overflow": float(program["overflow"]), "answer": 0.0,
           "features": 0.0, "bev": 0.0, "bev_chain": 0.0, "logits": 0.0,
           "boxes": 0.0}
    bevs = program["bevs"]
    for i, got in program["features"].items():
        out["features"] = max(out["features"], max(
            rel(a, b) for a, b in zip(got, ref_run.feats(i))))
    for i in picks:
        prev = None if t.starts_scene(i) else bevs[i - 1]
        bev, cls, box = ref_run.request(i, prev)
        out["bev"] = max(out["bev"], rel(bevs[i], bev))
        pcls, pbox = program["heads"][i]
        out["logits"] = max(out["logits"], max(
            rel(pcls[l, 0], cls[l, 0]) for l in range(cls.shape[0])))
        out["boxes"] = max(out["boxes"], max(
            rel(pbox[l, 0], box[l, 0]) for l in range(box.shape[0])))
        if answers:
            out["answer"] = max(out["answer"], served_gap(
                program["answers"][i], pcls[-1, 0], pbox[-1, 0], coder))
    if chain_last in bevs:
        out["bev_chain"] = rel(bevs[chain_last], ref_run.chain(chain_last))
    else:  # the window did not reach the chain's last frame
        out["bev_chain"] = 1.0
    return out


def check(run):
    """The program's side taken, its state freed, then the reference."""
    picks = [i for i in run.picks if i < run.requests]
    program_out = program_side(run.captured, picks)
    run.captured = run.engine = run.model = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    strict_float32()
    ref_run = BEVReference(run.ref_mod, run.model_dict, run.sd, run.traffic)
    with torch.no_grad():
        return compare(program_out, ref_run, picks,
                       run.traffic_spec["chain_frames"] - 1,
                       run.model_dict["coder"])
