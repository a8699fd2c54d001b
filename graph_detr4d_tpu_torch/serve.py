"""Inference engines (counterpart of tools/serve.py::Engine: infer,
infer_stream, reset_stream, the lock and the served counter; the HTTP
front end is tools/serve.py, the artifact tools/export_model.py).

    from graph_detr4d_tpu_torch.serve import Engine
    engine = Engine("detr4d_res50_deform_pe_testaug_2subset_12e", state_dict)
    det = engine.infer(images, lidar2img)   # numpy in, numpy out
    det = engine.infer_stream(new_frame, lidar2img, stream="car-7")
    engine = Engine.from_artifact("work_dirs/export")  # an exported artifact

`state_dict` uses the reference's names: a published mmdet3d checkpoint,
`weights.state_dict_from_jax(...)` of JAX weights, or a port model's own.

The LiDAR detector (models/dgcnn.py::ObjDGCNN) answers the same way:

    from graph_detr4d_tpu_torch.serve import LidarEngine
    engine = LidarEngine(state_dict)        # weights.obj_dgcnn_state_dict_from_jax
    det = engine.infer(points, mask)        # (B, P, 5) float32, (B, P)
"""

import contextlib
import json
import os
import threading
from collections import OrderedDict

import numpy as np
import torch

from . import tracing
from .config import CoderConfig
from .configs import get_config
from .core.coder import decode_batch
from .models.detector import GraphDETR4D
from .models.dgcnn import ObjDGCNN
from .ops import build, launch_counters
from .utils.device import resolve_device

MANIFEST, WEIGHTS = "manifest.json", "weights.pth"


def extras_spec(cfg, batch_size: int):
    """[(name, shape)] of the extra serving inputs a config needs, in
    artifact order (tools/export_model.py::_extras_spec): the temporal PETR
    heads' mean_time_stamp (petrv2, and petr_seg on a rig with past-frame
    cameras), the camera-aware head's intrinsics and ida_scale,
    scale_pred's depth_factors. Without mean_time_stamp a PETRv2 answer
    would keep its velocity undivided."""
    B, N = batch_size, cfg.head.num_cams
    spec = []
    if cfg.head_type == "petrv2" or (
            cfg.head_type == "petr_seg"
            and cfg.head.num_cams > cfg.head.num_frame_cams):
        spec.append(("mean_time_stamp", (B,)))
    if cfg.head.cam_aware:
        spec.append(("intrinsics", (B, N, 4, 4)))
        spec.append(("ida_scale", (B, N)))
    if cfg.head.scale_pred:
        spec.append(("depth_factors", (B,)))
    return spec


def synth_extra(name, shape):
    """Placeholder value for an extra input (warm-up, bench, verify), as
    tools/serve.py::synth_extra makes it."""
    if name == "intrinsics":
        v = np.tile(np.eye(4, dtype=np.float32), tuple(shape[:-2]) + (1, 1))
        v[..., 0, 0] = v[..., 1, 1] = 1000.0
        v[..., 0, 2], v[..., 1, 2] = 400.0, 225.0
        return v
    if name == "mean_time_stamp":
        return np.full(shape, 0.5, np.float32)
    return np.ones(shape, np.float32)


def artifact_config(manifest: dict):
    """The ModelConfig an artifact was exported from: its named config (or
    tiny_test_config for 'tiny') with its --cfg-options, and raw-pixel
    ingest (device_normalize) as img_norm.on_device says."""
    import dataclasses

    from .config import tiny_test_config
    from .configs import apply_overrides

    opts = manifest.get("cfg_options") or []
    if manifest["config"] == "tiny":
        cfg = apply_overrides(tiny_test_config(), opts)
    else:
        cfg = get_config(manifest["config"], opts)
    return dataclasses.replace(
        cfg, device_normalize=bool(manifest["img_norm"]["on_device"]))


class Engine:
    """A GraphDETR4D on one device, warmed up, answering requests.

    infer(images (B, N, H, W, 3), lidar2img (B, N, 4, 4), extras) returns
    the NMS-free decode of the final decoder layer as numpy: 'bboxes'
    (B, max_num, 9), 'scores', 'labels', 'valid' (B, max_num), plus
    'cam_overflow', the in-view queries the per-camera compaction dropped
    (0 means it was exact; always 0 for the dense PETR heads). `extras`:
    the config's extra inputs (`extras_spec`: mean_time_stamp, intrinsics,
    ida_scale, depth_factors), in that order.

    infer_stream(images, lidar2img, extras, stream) answers a request of a
    video stream from its new frame only (the temporal configs: num_cams
    = 2 x num_frame_cams): the backbone runs on the new frame's cameras,
    and the previous frame's features come from the stream's cache, which
    keeps each stream's last `extract_feats` list on the device, the
    `max_streams` most recently used streams, the oldest evicted first.

    One lock serializes the device calls and the cache's mutations, so
    server threads may share an Engine; the host-to-device copy of a
    request happens before it, outside the lock, and the device-to-host
    read after it. `served` counts the answered requests; `stream_hits`,
    `stream_misses` (a stream's first request, or its first after a reset
    or an eviction) and `stream_evictions` count the stream cache's work
    (`counters()` reads them all). Each request is a `tracing` span
    `engine.request`. An Engine made from a streaming artifact
    (`from_artifact`) answers infer by encoding the two frame halves
    separately, then running the head, as the JAX engine runs its two
    programs.
    """

    def __init__(self, config, state_dict, device="cuda", max_streams=16,
                 manifest=None):
        """config: a name from configs.py or a ModelConfig; manifest: the
        artifact's, when the Engine serves one."""
        self.device = resolve_device(device)
        self.cfg = get_config(config) if isinstance(config, str) else config
        self.model = GraphDETR4D(self.cfg, device=self.device)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.eval()
        self.manifest = manifest
        self.streaming = (manifest or {}).get("streaming")
        B = manifest["batch_size"] if manifest else 1
        self.extras_spec = (
            [(n, tuple(manifest["inputs"][n][0])) for n in manifest["extras"]]
            if manifest else extras_spec(self.cfg, B))
        self.max_streams = max_streams
        self._streams = OrderedDict()  # stream id -> features, LRU order
        self._lock = threading.Lock()
        self.served = self.stream_hits = self.stream_misses = 0
        self.stream_evictions = 0
        # warm-up: cuDNN / cuBLAS heuristics, kernel build and load
        h = self.cfg.head
        N, nf, (H, W) = h.num_cams, h.num_frame_cams, self.cfg.img_size
        img_dtype = np.uint8 if self.cfg.device_normalize else np.float32
        l2i = np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1))
        extras = [synth_extra(n, s) for n, s in self.extras_spec]
        with tracing.span("engine.warm.infer", always=True):
            self.infer(np.zeros((B, N, H, W, 3), img_dtype), l2i, extras)
        if N == 2 * nf:  # the backbone at one frame's cameras
            with tracing.span("engine.warm.infer_stream", always=True):
                self.infer_stream(np.zeros((B, nf, H, W, 3), img_dtype), l2i,
                                  extras, stream=None)
            self._streams.clear()
        # the warm-up is not a request (JAX counts it)
        self.served = self.stream_hits = self.stream_misses = 0
        self.stream_evictions = 0

    @classmethod
    def from_artifact(cls, artifact_dir, device="cuda", max_streams=16):
        """An Engine serving an artifact of tools/export_model.py: its
        manifest.json rebuilds the config, weights.pth (a reference-layout
        state_dict, read with weights_only) holds the weights."""
        with open(os.path.join(artifact_dir, MANIFEST)) as f:
            manifest = json.load(f)
        sd = torch.load(os.path.join(artifact_dir, WEIGHTS),
                        map_location="cpu", weights_only=True)
        return cls(artifact_config(manifest), sd, device=device,
                   max_streams=max_streams, manifest=manifest)

    def _device_calls(self):
        """The lock, and on a card its device as the thread's current one
        (the current device is per thread)."""
        stack = contextlib.ExitStack()
        stack.enter_context(self._lock)
        if self.device.type == "cuda":
            stack.enter_context(torch.cuda.device(self.device))
        return stack

    def _answer(self, out) -> dict:
        c = self.cfg.coder
        det = decode_batch(
            out,
            max_num=c.max_num,
            post_center_range=c.post_center_range,
            score_threshold=c.score_threshold,
        )
        return det, out["cam_overflow"]

    @staticmethod
    def _to_host(answer) -> dict:
        det, overflow = answer
        result = {k: v.cpu().numpy() for k, v in det._asdict().items()}
        result["cam_overflow"] = float(overflow)
        return result

    def _inputs(self, images, lidar2img, extras):
        kw = {name: torch.as_tensor(np.asarray(v, np.float32)).to(self.device)
              for (name, _), v in zip(self.extras_spec, extras)}
        return (torch.as_tensor(images).to(self.device),
                torch.as_tensor(lidar2img, dtype=torch.float32).to(self.device),
                kw)

    def _halves(self, images):
        """extract_feats of the current and the previous frame's cameras
        of a full rig, encoded separately, joined along the camera axis."""
        nf = self.cfg.head.num_frame_cams
        cur = self.model.extract_feats(images[:, :nf])
        prev = self.model.extract_feats(images[:, nf:])
        return [torch.cat([c, p], dim=1) for c, p in zip(cur, prev)]

    def counters(self) -> dict:
        """Every counter of the serving path in one flat dict: the
        Engine's, the live streams, the kernel builds (ops/build.py) and
        the kernels' launch counters (which stay in their modules)."""
        return {
            "served": self.served, "stream_hits": self.stream_hits,
            "stream_misses": self.stream_misses,
            "stream_evictions": self.stream_evictions,
            "streams": len(self._streams),
            "builds": build.builds, "build_s": build.build_s,
            **launch_counters(),
        }

    @torch.inference_mode()
    def infer(self, images, lidar2img, extras=()) -> dict:
        with tracing.span("engine.request"):
            images, lidar2img, kw = self._inputs(images, lidar2img, extras)
            with self._device_calls():
                if self.streaming:
                    out = self.model.forward_feats(self._halves(images),
                                                   lidar2img, **kw)
                else:
                    out = self.model(images, lidar2img, **kw)
                answer = self._answer(out)
                self.served += 1
            return self._to_host(answer)

    @torch.inference_mode()
    def infer_stream(self, images, lidar2img, extras=(),
                     stream="default") -> dict:
        """images (B, num_frame_cams, H, W, 3): the new frame only;
        lidar2img (B, num_cams, 4, 4): the current cameras first, then the
        cached frame's, mapped into the current lidar frame. On a stream's
        first request the new frame doubles as the previous one (as the
        data loader does when a sample has no sweep). The head runs on the
        features [current | previous] along the camera axis."""
        h = self.cfg.head
        if h.num_cams != 2 * h.num_frame_cams:
            raise ValueError(f"infer_stream needs a temporal config (num_cams "
                             f"{h.num_cams} = 2 x num_frame_cams "
                             f"{h.num_frame_cams})")
        with tracing.span("engine.request"):
            images, lidar2img, kw = self._inputs(images, lidar2img, extras)
            with self._device_calls():
                cur = self.model.extract_feats(images)
                prev = self._streams.get(stream)
                if prev is None:
                    self.stream_misses += 1
                    prev = cur
                else:
                    self.stream_hits += 1
                out = self.model.forward_feats(
                    [torch.cat([c, p], dim=1) for c, p in zip(cur, prev)],
                    lidar2img, **kw)
                self._streams[stream] = cur
                self._streams.move_to_end(stream)
                while len(self._streams) > self.max_streams:
                    self._streams.popitem(last=False)
                    self.stream_evictions += 1
                answer = self._answer(out)
                self.served += 1
            return self._to_host(answer)

    def reset_stream(self, stream="default") -> bool:
        """Drop a stream's cached frame; whether it had one."""
        with self._lock:
            return self._streams.pop(stream, None) is not None


class LidarEngine:
    """An ObjDGCNN on one device, warmed up, answering requests.

    infer(points (B, P, 5) float32, mask (B, P)) returns the NMS-free
    decode of the final decoder layer as numpy: 'bboxes' (B, max_num, 9),
    'scores', 'labels', 'valid' (B, max_num), decoded with CoderConfig's
    defaults. The model is ObjDGCNN at the JAX module's defaults.
    """

    def __init__(self, state_dict, device="cuda"):
        self.device = resolve_device(device)
        self.coder = CoderConfig()
        self.model = ObjDGCNN(device=self.device)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.eval()
        # warm-up: cuDNN / cuBLAS heuristics, kernel build and load
        self.infer(np.zeros((1, 1024, 5), np.float32),
                   np.ones((1, 1024), np.float32))

    @torch.inference_mode()
    def infer(self, points, mask) -> dict:
        points = torch.as_tensor(points, dtype=torch.float32).to(self.device)
        mask = torch.as_tensor(mask).to(self.device)
        out = self.model(points, mask)
        c = self.coder
        det = decode_batch(out, max_num=c.max_num,
                           post_center_range=c.post_center_range,
                           score_threshold=c.score_threshold)
        return {k: v.cpu().numpy() for k, v in det._asdict().items()}
