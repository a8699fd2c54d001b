"""Inference engines (counterpart of tools/serve.py::Engine: infer,
infer_stream, reset_stream, the lock and the served counter; the HTTP
front end is tools/serve.py, the artifact tools/export_model.py).

    from graph_detr4d_tpu_torch.serve import Engine
    engine = Engine("detr4d_res50_deform_pe_testaug_2subset_12e", state_dict)
    det = engine.infer(images, lidar2img)   # numpy in, numpy out
    det = engine.infer_stream(new_frame, lidar2img, stream="car-7")
    engine = Engine.from_artifact("work_dirs/export")  # an exported artifact

A stream's state is what its model carries between frames: the previous
frame's camera features (the temporal configs), or BEVFormer's previous
BEV and the pose it was made at (`bevformer_base`, whose requests carry
the frame's absolute `can_bus` as an extra):

    engine = Engine("bevformer_base", state_dict)
    det = engine.infer_stream(frame, lidar2img, [can_bus], stream="car-7")

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
from .models.bevformer import CAN_BUS_DIMS
from .models.detector import GraphDETR4D
from .models.dgcnn import ObjDGCNN
from .ops import build, launch_counters
from .parallel.transfer import StagedCopy, host_cast, host_tensor
from .utils.device import resolve_device

MANIFEST, WEIGHTS = "manifest.json", "weights.pth"


def extras_spec(cfg, batch_size: int):
    """[(name, shape)] of the extra serving inputs a config needs, in
    artifact order (tools/export_model.py::_extras_spec): the temporal PETR
    heads' mean_time_stamp (petrv2, and petr_seg on a rig with past-frame
    cameras), the camera-aware head's intrinsics and ida_scale,
    scale_pred's depth_factors, BEVFormer's can_bus (the frame's absolute
    ego pose and motion, 18 values). Without mean_time_stamp a PETRv2
    answer would keep its velocity undivided."""
    B, N = batch_size, cfg.head.num_cams
    spec = []
    if cfg.head_type == "bevformer":
        spec.append(("can_bus", (B, CAN_BUS_DIMS)))
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
    if name == "can_bus":
        return np.zeros(shape, np.float32)
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
    video stream from its new frame only: the backbone runs on the new
    frame's cameras, and the stream's cache keeps each stream's state on
    the device, the `max_streams` most recently used streams, the oldest
    evicted first. The state is the model's: for the temporal configs
    (num_cams = 2 x num_frame_cams) the last `extract_feats` list, read
    as the previous frame's features; for BEVFormer the last `bev_embed`
    and the pose (x, y, z, yaw in degrees: can_bus[:3] and can_bus[-1])
    it was made at. BEVFormer's request carries its absolute can_bus;
    the Engine turns it into the frame's motion, its translation and yaw
    less the cached pose's (zero on a stream's first request, which has
    no previous BEV), as the published test loop does; `infer` answers
    as a stream's first request.

    One lock serializes the device calls and the cache's mutations, so
    server threads may share an Engine; the host-to-device copy of a
    request happens before it, outside the lock, and the device-to-host
    read after it. The copy (parallel/transfer.py::StagedCopy) goes
    through pinned buffers the warm-ups make and later requests reuse,
    and is issued without waiting; float32 images cross as bfloat16,
    cast on the host while they are written into the buffer, where the
    model's first use of them is that cast (`transfer.host_cast`: a bf16
    config without device_normalize).
    `served` counts the answered requests; `h2d_staged` those whose
    images went through the pinned buffers (none on the CPU) and
    `h2d_host_cast` those whose images the host cast; `stream_hits`,
    `stream_misses` (a stream's first request, or its first after a reset
    or an eviction) and `stream_evictions` count the stream cache's work
    (`counters()` reads them all). Each request is a `tracing` span
    `engine.request`, its copy a host span `engine.h2d` inside it. An
    Engine made from a streaming artifact
    (`from_artifact`) answers infer by encoding the two frame halves
    separately, then running the head, as the JAX engine runs its two
    programs.

    The flagship's head and MP's (models/head.py::Detr3DHeadPE, every
    decoder layer with the deform3d or every one with the MP
    cross-attention) and BEVFormer's (models/bevformer.py) answer as
    CUDA graphs between their K1 calls and eager stretches (MP's query
    graphs, the openings and closings of MP's and BEVFormer's spans):
    the first request of an input signature runs the head eagerly, the
    second captures the graphs, later ones replay them. A temporal
    config's two warm-ups (`infer`, then `infer_stream`) send the head
    the one signature of a full rig twice, so the capture happens in
    __init__ and every request replays. BEVFormer's head has two
    signatures, a stream's first frame (no previous BEV) and a later
    one; its warm-ups (`infer`, then three `infer_stream` of one stream)
    send each twice, so both are captured in __init__. A replay copies
    the request's tensors into the graphs' inputs and returns fresh
    tensors, `cam_overflow` and the BEV the stream cache keeps included,
    that no later request writes. The PETR heads and the DETR3D and
    DETR3D-v2 cross-attentions run eagerly. `head_graph_captures` and
    `head_graph_replays` count it (`counters()`); the warm-ups' captures
    stay counted, so replays / served is the share of requests that
    replayed.

    The MP cross-attention (models/attention_variants.py::
    Deform3DCrossAttnMP) builds a query graph in each decoder layer and
    samples the K graph neighbours of each query in a K1 call of its own:
    `mp_graph_builds` counts the graphs (one a sample a layer) and
    `mp_neighbour_rows` the rows of those calls (B x K x Q a layer), the
    warm-ups' included, replayed requests as eager ones (the capture
    counts nothing). Both count since the model was built, so they stay
    0 for a head that is not MP.

    BEVFormer's head: `bev_sca_rows` counts the rows its spatial
    cross-attention's K1 calls sampled (cameras x capacity a layer) and
    `bev_sca_overflow` the in-view BEV queries its capacity dropped (a
    request's `cam_overflow` too), both since the model was built, the
    warm-ups' included, replayed requests as eager ones; 0 for any other
    head.
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
        # stream id -> state (features, or BEVFormer's (bev, pose)), LRU order
        self._streams = OrderedDict()
        self.bev_state = self.cfg.head_type == "bevformer"
        self._lock = threading.Lock()
        self._staging = StagedCopy(self.device)
        self.served = self.stream_hits = self.stream_misses = 0
        self.stream_evictions = self.h2d_staged = self.h2d_host_cast = 0
        # warm-up: cuDNN / cuBLAS heuristics, kernel build and load
        h = self.cfg.head
        N, nf, (H, W) = h.num_cams, h.num_frame_cams, self.cfg.img_size
        img_dtype = np.uint8 if self.cfg.device_normalize else np.float32
        l2i = np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1))
        extras = [synth_extra(n, s) for n, s in self.extras_spec]
        with tracing.span("engine.warm.infer", always=True):
            self.infer(np.zeros((B, N, H, W, 3), img_dtype), l2i, extras)
        if self.bev_state:  # a stream's first request, then two with a BEV
            with tracing.span("engine.warm.infer_stream", always=True):
                for _ in range(3):
                    self.infer_stream(np.zeros((B, N, H, W, 3), img_dtype),
                                      l2i, extras, stream=None)
            self._streams.clear()
        elif N == 2 * nf:  # the backbone at one frame's cameras
            with tracing.span("engine.warm.infer_stream", always=True):
                self.infer_stream(np.zeros((B, nf, H, W, 3), img_dtype), l2i,
                                  extras, stream=None)
            self._streams.clear()
        # the warm-up is not a request (JAX counts it)
        self.served = self.stream_hits = self.stream_misses = 0
        self.stream_evictions = self.h2d_staged = self.h2d_host_cast = 0

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
        """The request's inputs on the device: (images, lidar2img, the
        extras by name, (staged, host cast): the route its images took,
        for `_count`)."""
        with tracing.span("engine.h2d"):
            images = host_tensor(images)
            dtype = host_cast(images.dtype, self.cfg.bf16,
                              self.cfg.device_normalize)
            on_host = images.device.type == "cpu"
            route = (on_host and self._staging.pinned,
                     on_host and dtype != images.dtype)
            kw = {name: self._staging(v, torch.float32)
                  for (name, _), v in zip(self.extras_spec, extras)}
            return (self._staging(images, dtype),
                    self._staging(lidar2img, torch.float32), kw, route)

    def _count(self, route):
        """One more request answered (under the lock)."""
        staged, cast = route
        self.served += 1
        self.h2d_staged += staged
        self.h2d_host_cast += cast

    def _halves(self, images):
        """extract_feats of the current and the previous frame's cameras
        of a full rig, encoded separately, joined along the camera axis."""
        nf = self.cfg.head.num_frame_cams
        cur = self.model.extract_feats(images[:, :nf])
        prev = self.model.extract_feats(images[:, nf:])
        return [torch.cat([c, p], dim=1) for c, p in zip(cur, prev)]

    def counters(self) -> dict:
        """Every counter of the serving path in one flat dict: the
        Engine's (requests, their copies' routes, the stream cache), the
        live streams, the kernel builds (ops/build.py) and
        the kernels' launch counters (which stay in their modules), the
        head's CUDA graphs: the calls that captured them and the calls
        that replayed them (0 for a head that runs eagerly), and MP's
        query graphs built and neighbour rows sampled (the sums of the
        head's decoder layers' and cross-attentions' counts, since the
        model was built), BEVFormer's SCA rows sampled and in-view queries
        dropped (since the model was built)."""
        head = self.model.pts_bbox_head
        graphs = getattr(head, "graphs", None)
        return {
            "served": self.served, "stream_hits": self.stream_hits,
            "stream_misses": self.stream_misses,
            "stream_evictions": self.stream_evictions,
            "streams": len(self._streams),
            "h2d_staged": self.h2d_staged, "h2d_host_cast": self.h2d_host_cast,
            "builds": build.builds, "build_s": build.build_s,
            "head_graph_captures": graphs.captures if graphs else 0,
            "head_graph_replays": graphs.replays if graphs else 0,
            "mp_graph_builds": sum(getattr(m, "mp_graph_builds", 0)
                                   for m in head.modules()),
            "mp_neighbour_rows": sum(getattr(m, "mp_neighbour_rows", 0)
                                     for m in head.modules()),
            "bev_sca_rows": sum(getattr(m, "bev_sca_rows", 0)
                                for m in head.modules()),
            "bev_sca_overflow": getattr(head, "bev_sca_overflow", 0.0),
            **launch_counters(),
        }

    @torch.inference_mode()
    def infer(self, images, lidar2img, extras=()) -> dict:
        with tracing.span("engine.request"):
            images, lidar2img, kw, route = self._inputs(images, lidar2img,
                                                        extras)
            with self._device_calls():
                if self.bev_state:
                    kw["can_bus"] = motion(kw["can_bus"], None)
                if self.streaming:
                    out = self.model.forward_feats(self._halves(images),
                                                   lidar2img, **kw)
                else:
                    out = self.model(images, lidar2img, **kw)
                answer = self._answer(out)
                self._count(route)
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
        if self.bev_state:
            return self._infer_bev_stream(images, lidar2img, extras, stream)
        h = self.cfg.head
        if h.num_cams != 2 * h.num_frame_cams:
            raise ValueError(f"infer_stream needs a temporal config (num_cams "
                             f"{h.num_cams} = 2 x num_frame_cams "
                             f"{h.num_frame_cams})")
        with tracing.span("engine.request"):
            images, lidar2img, kw, route = self._inputs(images, lidar2img,
                                                        extras)
            with self._device_calls():
                cur = self.model.extract_feats(images)
                prev = self._cached(stream)
                if prev is None:
                    prev = cur
                out = self.model.forward_feats(
                    [torch.cat([c, p], dim=1) for c, p in zip(cur, prev)],
                    lidar2img, **kw)
                self._keep(stream, cur)
                answer = self._answer(out)
                self._count(route)
            return self._to_host(answer)

    def _infer_bev_stream(self, images, lidar2img, extras, stream):
        """infer_stream for BEVFormer: images (B, num_cams, H, W, 3), the
        new frame; lidar2img (B, num_cams, 4, 4); extras [can_bus (B,
        18)], absolute. The head reads the stream's previous BEV and the
        frame's motion since its pose; the stream keeps the new BEV and
        pose."""
        with tracing.span("engine.request"):
            images, lidar2img, kw, route = self._inputs(images, lidar2img,
                                                        extras)
            with self._device_calls():
                feats = self.model.extract_feats(images)
                can_bus = kw.pop("can_bus")
                prev_bev, pose = self._cached(stream) or (None, None)
                out = self.model.forward_feats(
                    feats, lidar2img, can_bus=motion(can_bus, pose),
                    prev_bev=prev_bev, **kw)
                self._keep(stream, (out["bev_embed"], pose_of(can_bus)))
                answer = self._answer(out)
                self._count(route)
            return self._to_host(answer)

    def _cached(self, stream):
        """The stream's cached state or None, counted as a hit or a miss
        (under the lock)."""
        state = self._streams.get(stream)
        if state is None:
            self.stream_misses += 1
        else:
            self.stream_hits += 1
        return state

    def _keep(self, stream, state):
        """Cache the stream's new state as the most recently used, the
        oldest streams past max_streams evicted (under the lock)."""
        self._streams[stream] = state
        self._streams.move_to_end(stream)
        while len(self._streams) > self.max_streams:
            self._streams.popitem(last=False)
            self.stream_evictions += 1

    def reset_stream(self, stream="default") -> bool:
        """Drop a stream's cached frame; whether it had one."""
        with self._lock:
            return self._streams.pop(stream, None) is not None


def pose_of(can_bus):
    """(B, 4) the pose a BEV is made at: can_bus[:3] and its yaw in
    degrees, can_bus[-1]."""
    return torch.cat([can_bus[:, :3], can_bus[:, -1:]], dim=-1).clone()


def motion(can_bus, pose):
    """can_bus (B, 18) with its translation and yaw in degrees made the
    motion since `pose` (`pose_of` of the previous frame), or zero where
    pose is None (a stream's first frame); the rest as it is."""
    out = can_bus.clone()
    if pose is None:
        out[:, :3] = 0.0
        out[:, -1] = 0.0
    else:
        out[:, :3] -= pose[:, :3]
        out[:, -1] -= pose[:, 3]
    return out


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
