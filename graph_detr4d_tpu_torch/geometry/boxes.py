"""3D box codec (counterpart of graph_detr4d_tpu/geometry/boxes.py).

code = (cx, cy, log w, log l, cz, log h, sin yaw, cos yaw[, vx, vy])
box  = (cx, cy, cz, w, l, h, yaw[, vx, vy])
"""

import torch


def normalize_bbox(bboxes: torch.Tensor) -> torch.Tensor:
    """Encode boxes (..., 7 or 9) to regression codes (..., 8 or 10). The
    reference's `pc_range` argument is unused there and left out here."""
    parts = [
        bboxes[..., 0:1],
        bboxes[..., 1:2],
        bboxes[..., 3:4].log(),
        bboxes[..., 4:5].log(),
        bboxes[..., 2:3],
        bboxes[..., 5:6].log(),
        bboxes[..., 6:7].sin(),
        bboxes[..., 6:7].cos(),
    ]
    if bboxes.shape[-1] > 7:
        parts += [bboxes[..., 7:8], bboxes[..., 8:9]]
    return torch.cat(parts, dim=-1)


def denormalize_bbox(codes: torch.Tensor) -> torch.Tensor:
    """Decode regression codes (..., 8 or 10) to boxes (..., 7 or 9)."""
    rot = torch.atan2(codes[..., 6:7], codes[..., 7:8])
    parts = [
        codes[..., 0:1],
        codes[..., 1:2],
        codes[..., 4:5],
        codes[..., 2:3].exp(),
        codes[..., 3:4].exp(),
        codes[..., 5:6].exp(),
        rot,
    ]
    if codes.shape[-1] > 8:
        parts += [codes[..., 8:9], codes[..., 9:10]]
    return torch.cat(parts, dim=-1)
