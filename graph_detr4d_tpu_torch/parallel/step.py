"""Eval steps (single-device counterparts of graph_detr4d_tpu/parallel/
step.py:146-207): a forward, then the NMS-free decode of the final
decoder layer. The JAX steps are jitted and, for build_eval_step, may be
sharded over a device mesh; these run eagerly on the model's device.

    step = build_tta_eval_step(model, cfg)
    det = step(images, lidar2img)  # images (A, B, N, H, W, 3) or A copies

Building the resized copies belongs to the data pipeline; callers pass
them with their calibrations.
"""

import torch

from ..config import ModelConfig
from ..core.coder import decode_batch


def _decode(out, cfg: ModelConfig):
    c = cfg.coder
    return decode_batch(out, max_num=c.max_num,
                        post_center_range=c.post_center_range,
                        score_threshold=c.score_threshold)


def build_eval_step(model, cfg: ModelConfig):
    """batch {'images' (B, N, H, W, 3), 'lidar2img' (B, N, 4, 4)} on the
    model's device -> Detections."""

    @torch.inference_mode()
    def eval_step(batch):
        return _decode(model(batch["images"], batch["lidar2img"]), cfg)

    return eval_step


def build_tta_eval_step(model, cfg: ModelConfig):
    """Test-time augmentation: `GraphDETR4D.aug_forward` over A augmented
    copies (images (A, B, N, H, W, 3), or a list of A), each with its own
    calibration (lidar2img (B, N, 4, 4) shared, or one per copy), the head
    outputs averaged, then decoded. (The JAX step's docstring says features
    are averaged under copy 0's calibration; the code it runs, and this,
    average outputs.)"""

    @torch.inference_mode()
    def tta_step(images, lidar2img):
        return _decode(model.aug_forward(list(images), lidar2img), cfg)

    return tta_step
