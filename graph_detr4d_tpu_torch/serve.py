"""In-process inference engine (counterpart of tools/serve.py::Engine's
infer, infer_stream and reset_stream, without HTTP).

    from graph_detr4d_tpu_torch.serve import Engine
    engine = Engine("detr4d_res50_deform_pe_testaug_2subset_12e", state_dict)
    det = engine.infer(images, lidar2img)   # numpy in, numpy out
    det = engine.infer_stream(new_frame, lidar2img, stream="car-7")

`state_dict` uses the reference's names: a published mmdet3d checkpoint,
`weights.state_dict_from_jax(...)` of JAX weights, or a port model's own.

The LiDAR detector (models/dgcnn.py::ObjDGCNN) answers the same way:

    from graph_detr4d_tpu_torch.serve import LidarEngine
    engine = LidarEngine(state_dict)        # weights.obj_dgcnn_state_dict_from_jax
    det = engine.infer(points, mask)        # (B, P, 5) float32, (B, P)
"""

from collections import OrderedDict

import numpy as np
import torch

from .config import CoderConfig
from .configs import get_config
from .core.coder import decode_batch
from .models.detector import GraphDETR4D
from .models.dgcnn import ObjDGCNN
from .utils.device import resolve_device


class Engine:
    """A GraphDETR4D on one device, warmed up, answering requests.

    infer(images (B, N, H, W, 3), lidar2img (B, N, 4, 4)) returns the
    NMS-free decode of the final decoder layer as numpy: 'bboxes'
    (B, max_num, 9), 'scores', 'labels', 'valid' (B, max_num), plus
    'cam_overflow', the in-view queries the per-camera compaction dropped
    (0 means it was exact).

    infer_stream(images, lidar2img, stream) answers a request of a video
    stream from its new frame only (the temporal configs: num_cams = 2 x
    num_frame_cams): the backbone runs on the new frame's cameras, and the
    previous frame's features come from the stream's cache, which keeps
    each stream's last `extract_feats` list on the device, the
    `max_streams` most recently used streams, the oldest evicted first.
    """

    def __init__(self, config, state_dict, device="cuda", max_streams=16):
        """config: a name from configs.py or a ModelConfig."""
        self.device = resolve_device(device)
        self.cfg = get_config(config) if isinstance(config, str) else config
        self.model = GraphDETR4D(self.cfg, device=self.device)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.eval()
        self.max_streams = max_streams
        self._streams = OrderedDict()  # stream id -> features, LRU order
        # warm-up: cuDNN / cuBLAS heuristics, kernel build and load
        h = self.cfg.head
        N, nf, (H, W) = h.num_cams, h.num_frame_cams, self.cfg.img_size
        l2i = np.tile(np.eye(4, dtype=np.float32), (1, N, 1, 1))
        self.infer(np.zeros((1, N, H, W, 3), np.float32), l2i)
        if N == 2 * nf:  # the backbone at one frame's cameras
            self.infer_stream(np.zeros((1, nf, H, W, 3), np.float32), l2i,
                              stream=None)
            self._streams.clear()

    def _answer(self, out) -> dict:
        c = self.cfg.coder
        det = decode_batch(
            out,
            max_num=c.max_num,
            post_center_range=c.post_center_range,
            score_threshold=c.score_threshold,
        )
        result = {k: v.cpu().numpy() for k, v in det._asdict().items()}
        result["cam_overflow"] = float(out["cam_overflow"])
        return result

    def _inputs(self, images, lidar2img):
        return (torch.as_tensor(images).to(self.device),
                torch.as_tensor(lidar2img, dtype=torch.float32).to(self.device))

    @torch.inference_mode()
    def infer(self, images, lidar2img) -> dict:
        images, lidar2img = self._inputs(images, lidar2img)
        return self._answer(self.model(images, lidar2img))

    @torch.inference_mode()
    def infer_stream(self, images, lidar2img, stream="default") -> dict:
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
        images, lidar2img = self._inputs(images, lidar2img)
        cur = self.model.extract_feats(images)
        prev = self._streams.get(stream, cur)
        out = self.model.forward_feats(
            [torch.cat([c, p], dim=1) for c, p in zip(cur, prev)], lidar2img)
        self._streams[stream] = cur
        self._streams.move_to_end(stream)
        while len(self._streams) > self.max_streams:
            self._streams.popitem(last=False)
        return self._answer(out)

    def reset_stream(self, stream="default") -> bool:
        """Drop a stream's cached frame; whether it had one."""
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
