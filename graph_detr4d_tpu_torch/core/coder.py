"""NMS-free box decoding (counterpart of graph_detr4d_tpu/core/coder.py;
reference: core/bbox/coders/nms_free_coder.py:17-120).

sigmoid scores -> flat top-k over query x class -> gather codes ->
denormalize -> post-center-range (+ optional score) filter, as a validity
mask over a fixed-size output. fp32 throughout. `nms_free_cls_decode` is
the softmax variant (NMSFreeClsCoder), which no model path calls.
"""

from typing import NamedTuple

import torch

from ..geometry.boxes import denormalize_bbox
from ..utils.device import device_constant


class Detections(NamedTuple):
    bboxes: torch.Tensor  # (..., max_num, 9)
    scores: torch.Tensor  # (..., max_num)
    labels: torch.Tensor  # (..., max_num) int32
    valid: torch.Tensor  # (..., max_num) bool


def _top_k(scores, max_num):
    """jax.lax.top_k over the last axis: a stable descending sort, so equal
    scores keep the lower index first (torch.topk does not promise that)."""
    top, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return top[..., :max_num], idx[..., :max_num]


def _gather_rows(x, idx):
    """x (..., Q, C) rows at idx (..., K) -> (..., K, C)."""
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _valid(boxes, top_scores, post_center_range, score_threshold):
    """Centre inside post_center_range (and score above the threshold)."""
    pcr = device_constant(post_center_range, torch.float32, boxes.device)
    valid = (boxes[..., :3] >= pcr[:3]).all(-1) & (
        boxes[..., :3] <= pcr[3:]
    ).all(-1)
    if score_threshold is not None:
        valid &= top_scores > score_threshold
    return valid


def nms_free_decode(
    cls_scores: torch.Tensor,  # (..., Q, num_classes) logits
    bbox_preds: torch.Tensor,  # (..., Q, 10) codes
    *,
    max_num: int = 300,
    post_center_range=(-61.2, -61.2, -10.0, 61.2, 61.2, 10.0),
    score_threshold: float | None = None,
) -> Detections:
    num_classes = cls_scores.shape[-1]
    scores = torch.sigmoid(cls_scores.float()).flatten(-2)
    top_scores, idx = _top_k(scores, max_num)
    labels = (idx % num_classes).to(torch.int32)
    codes = _gather_rows(bbox_preds.float(), idx // num_classes)
    boxes = denormalize_bbox(codes)
    return Detections(boxes, top_scores, labels,
                      _valid(boxes, top_scores, post_center_range,
                             score_threshold))


def nms_free_cls_decode(
    cls_scores: torch.Tensor,  # (..., Q, num_classes + 1) logits, background last
    bbox_preds: torch.Tensor,  # (..., Q, 10) codes
    *,
    max_num: int = 300,
    post_center_range=(-61.2, -61.2, -10.0, 61.2, 61.2, 10.0),
    score_threshold: float | None = None,
) -> Detections:
    """Softmax variant (NMSFreeClsCoder, nms_free_coder.py:125-233):
    per-query softmax in fp32 over the classes and the background, the
    background dropped, the max class of each query (the first of equal
    ones), then a flat top-k over the queries."""
    probs = torch.softmax(cls_scores.float(), dim=-1)[..., :-1]
    per_q_score = probs.max(dim=-1).values
    per_q_label = probs.argmax(dim=-1).to(torch.int32)
    top_scores, idx = _top_k(per_q_score, max_num)
    labels = torch.gather(per_q_label, -1, idx)
    boxes = denormalize_bbox(_gather_rows(bbox_preds.float(), idx))
    return Detections(boxes, top_scores, labels,
                      _valid(boxes, top_scores, post_center_range,
                             score_threshold))


def decode_batch(preds: dict, **kw) -> Detections:
    """Decode the final decoder layer of a whole batch: each field gets a
    leading batch axis."""
    return nms_free_decode(
        preds["all_cls_scores"][-1], preds["all_bbox_preds"][-1], **kw
    )
