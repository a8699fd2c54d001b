"""In-process inference engine (counterpart of tools/serve.py::Engine.infer,
without HTTP).

    from graph_detr4d_tpu_torch.serve import Engine
    engine = Engine("detr4d_res50_deform_pe_testaug_2subset_12e", state_dict)
    det = engine.infer(images, lidar2img)   # numpy in, numpy out

`state_dict` uses the reference's names: a published mmdet3d checkpoint,
`weights.state_dict_from_jax(...)` of JAX weights, or a port model's own.

The LiDAR detector (models/dgcnn.py::ObjDGCNN) answers the same way:

    from graph_detr4d_tpu_torch.serve import LidarEngine
    engine = LidarEngine(state_dict)        # weights.obj_dgcnn_state_dict_from_jax
    det = engine.infer(points, mask)        # (B, P, 5) float32, (B, P)
"""

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
    """

    def __init__(self, config, state_dict, device="cuda"):
        """config: a name from configs.py or a ModelConfig."""
        self.device = resolve_device(device)
        self.cfg = get_config(config) if isinstance(config, str) else config
        self.model = GraphDETR4D(self.cfg, device=self.device)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.eval()
        # warm-up: cuDNN / cuBLAS heuristics, kernel build and load
        N, (H, W) = self.cfg.head.num_cams, self.cfg.img_size
        self.infer(np.zeros((1, N, H, W, 3), np.float32),
                   np.tile(np.eye(4, dtype=np.float32), (1, N, 1, 1)))

    @torch.inference_mode()
    def infer(self, images, lidar2img) -> dict:
        images = torch.as_tensor(images).to(self.device)
        lidar2img = torch.as_tensor(lidar2img, dtype=torch.float32).to(
            self.device)
        out = self.model(images, lidar2img)
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
