"""nuScenes detection metrics (mAP / ATE / ASE / AOE / AVE / AAE / NDS)
(counterpart of graph_detr4d_tpu/eval/nuscenes_metrics.py, numpy on the
host, the same protocol and the same numbers).

The reference hands evaluation to the nuscenes-devkit
(datasets/multi_nuscenes_dataset.py:196-260 -> NuScenesEval); this is the
published CVPR-2019 detection protocol written out:

  * greedy centre-distance matching at thresholds {0.5, 1, 2, 4} m;
  * 101-point interpolated precision/recall, AP above recall and
    precision 0.1;
  * TP errors at 2.0 m: translation (m), scale (1 - aligned 3D IoU),
    orientation (rad, period pi for barriers), velocity (m/s; none for
    barrier and cone), attribute (when GT attribute names are given);
    the devkit's cummean with NaN rows counted as it counts them;
  * per-class range filtering from the ego origin, the optional
    bike-rack filter, and NDS = (5 mAP + sum(1 - min(1, mTP))) / 10.

Matching uses centre distance, which rigid transforms keep, so boxes may
be given in any consistent per-sample frame (lidar or global). Without
GT attributes the AAE term of NDS is its best case 1.0.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import NUSCENES_CLASSES
from .submission import CLASS_RANGE

# detection_cvpr_2019 ranges (single source: submission.CLASS_RANGE),
# ordered by the canonical label ids (data/nuscenes.py
# NUSCENES_NAME_TO_LABEL) so the default class_names match the
# detector's label space
DEFAULT_CLASS_RANGE = {n: CLASS_RANGE[n] for n in NUSCENES_CLASSES}


@dataclass
class DetectionConfig:
    class_names: Sequence[str] = tuple(DEFAULT_CLASS_RANGE)
    dist_ths: Sequence[float] = (0.5, 1.0, 2.0, 4.0)
    dist_th_tp: float = 2.0
    min_recall: float = 0.1
    min_precision: float = 0.1
    max_boxes_per_sample: int = 500
    class_range: Dict[str, float] = field(
        default_factory=lambda: dict(DEFAULT_CLASS_RANGE)
    )


def _yaw_diff(a, b, period=2 * np.pi):
    d = (a - b) % period
    return np.minimum(d, period - d)


# classes subject to the devkit's bike-rack filter (filter_eval_boxes:
# boxes whose center lies inside a `static_object.bicycle_rack`
# annotation box are removed from BOTH predictions and GT)
_BIKE_RACK_CLASSES = ("bicycle", "motorcycle")


def _center_in_any_rack(xyz: np.ndarray, racks: np.ndarray) -> np.ndarray:
    """(n,) bool: is each center inside any rack box.

    `racks` is (m, 7) in the detector box layout (cx, cy, cz, w, l, h,
    yaw) with w = x-extent, l = y-extent in the box frame — the same
    convention as gt_boxes. Mirrors the devkit's
    `points_in_box(rack, box.translation)` test (oriented 3D
    containment, wlh_factor 1)."""
    racks = np.asarray(racks, np.float64).reshape(-1, 7)
    if len(racks) == 0 or len(xyz) == 0:
        return np.zeros(len(xyz), bool)
    d = xyz[:, None, :] - racks[None, :, :3]  # (n, m, 3)
    c, s = np.cos(racks[:, 6]), np.sin(racks[:, 6])
    # rotate into each rack's frame: R(-yaw) @ (p - c)
    px = c * d[..., 0] + s * d[..., 1]
    py = -s * d[..., 0] + c * d[..., 1]
    inside = (
        (np.abs(px) <= racks[None, :, 3] / 2)
        & (np.abs(py) <= racks[None, :, 4] / 2)
        & (np.abs(d[..., 2]) <= racks[None, :, 5] / 2)
    )
    return inside.any(axis=1)


def _aligned_iou(size_a, size_b):
    """3D IoU of two boxes with aligned center and yaw: per-axis min/max."""
    inter = np.prod(np.minimum(size_a, size_b))
    union = np.prod(size_a) + np.prod(size_b) - inter
    return inter / max(union, 1e-9)


class _Boxes:
    """Per-sample arrays: xyz (n,3), size (n,3) wlh, yaw (n,), vel (n,2),
    label (n,), score (n,), attr (n,) attribute-name strings ('' = none)."""

    def __init__(self, xyz, size, yaw, vel, label, score=None, attr=None):
        self.xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
        self.size = np.asarray(size, np.float64).reshape(-1, 3)
        self.yaw = np.asarray(yaw, np.float64).reshape(-1)
        self.vel = np.asarray(vel, np.float64).reshape(-1, 2)
        self.label = np.asarray(label).reshape(-1)
        self.score = (
            np.asarray(score, np.float64).reshape(-1)
            if score is not None
            else np.zeros(len(self.yaw))
        )
        self.attr = (
            np.asarray(attr, object).reshape(-1)
            if attr is not None
            else np.asarray([""] * len(self.yaw), object)
        )

    def __len__(self):
        return len(self.yaw)


class DetectionEvaluator:
    """Accumulates (pred, gt) box sets per sample, then computes metrics.

    add_sample accepts detector-layout boxes (cx, cy, cz, w, l, h, yaw, vx,
    vy) plus integer labels and scores.
    """

    def __init__(self, cfg: DetectionConfig | None = None):
        self.cfg = cfg or DetectionConfig()
        self.preds: List[_Boxes] = []
        self.gts: List[_Boxes] = []
        self.ego_xys: List[Optional[np.ndarray]] = []
        self._have_attrs = False

    def add_sample(
        self,
        pred_boxes: np.ndarray,
        pred_labels: np.ndarray,
        pred_scores: np.ndarray,
        gt_boxes: np.ndarray,
        gt_labels: np.ndarray,
        gt_attrs=None,  # (n,) attribute-name strings; enables AAE
        ego_xy=None,  # (2,) ego origin in the boxes' frame; see below
        bike_racks=None,  # (m, 7) bicycle_rack boxes; see below
    ):
        """Labels are indices into cfg.class_names (the detector's label
        space) for BOTH predictions and GT.

        `ego_xy` is the ego-vehicle origin expressed in the same frame
        as the boxes (for lidar-frame boxes: -R_l2e^T t_l2e, ~(-0.9, 0)
        on nuScenes). The devkit's per-class range filter cuts on
        distance from the EGO, not the lidar origin; omitting ego_xy
        falls back to the boxes' origin (a <=0.94 m boundary bias vs the
        devkit).

        `bike_racks` (optional, default off): the sample's
        `static_object.bicycle_rack` annotation boxes, (m, 7) in the
        same frame and (cx, cy, cz, w, l, h, yaw) layout as gt_boxes.
        When given, bicycle/motorcycle boxes (pred AND gt) whose center
        lies inside any rack are removed — the devkit's
        filter_eval_boxes bike-rack rule, the one filtering step beyond
        range/zero-point the devkit applies.

        Z CONVENTION: cz is the 3D CENTER for boxes AND racks (devkit
        Box.translation; this repo's coder regresses center-z,
        geometry/boxes.py denormalize_bbox). A caller holding
        mmdet3d-style BOTTOM-center boxes must convert (cz += h/2)
        first, or the rack containment test |dz| <= h/2 is shifted by
        half a box height and bikes parked ON TOP of racks filter
        differently from the devkit
        (tests/test_eval.py::test_bike_rack_filter_z_convention)."""
        pred_boxes = np.asarray(pred_boxes, np.float64).reshape(-1, 9)
        gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 9)

        if bike_racks is not None:
            names = list(self.cfg.class_names)
            rack_cls = {
                i for i, n in enumerate(names) if n in _BIKE_RACK_CLASSES
            }

            def keep(boxes, labels):
                labels = np.asarray(labels).reshape(-1)
                is_bike = np.isin(labels, list(rack_cls) or [-1])
                inside = _center_in_any_rack(boxes[:, :3], bike_racks)
                return ~(is_bike & inside)

            kp = keep(pred_boxes, pred_labels)
            pred_boxes = pred_boxes[kp]
            pred_labels = np.asarray(pred_labels).reshape(-1)[kp]
            pred_scores = np.asarray(pred_scores).reshape(-1)[kp]
            kg = keep(gt_boxes, gt_labels)
            gt_boxes = gt_boxes[kg]
            gt_labels = np.asarray(gt_labels).reshape(-1)[kg]
            if gt_attrs is not None:
                gt_attrs = np.asarray(gt_attrs, object).reshape(-1)[kg]
        k = min(len(pred_boxes), self.cfg.max_boxes_per_sample)
        order = np.argsort(-np.asarray(pred_scores))[:k]
        # predicted attribute = the formatter's speed rule applied at
        # submission time (multi_nuscenes_dataset.py:149-170)
        from .submission import select_attribute

        names = list(self.cfg.class_names)
        plabels = np.asarray(pred_labels)[order]
        pvel = pred_boxes[order, 7:9]
        pattrs = np.asarray(
            [
                select_attribute(names[int(l)], v)
                if 0 <= int(l) < len(names)
                else ""
                for l, v in zip(plabels, pvel)
            ],
            object,
        )
        self.preds.append(
            _Boxes(
                pred_boxes[order, :3],
                pred_boxes[order, 3:6],
                pred_boxes[order, 6],
                pred_boxes[order, 7:9],
                plabels,
                np.asarray(pred_scores)[order],
                pattrs,
            )
        )
        if gt_attrs is not None:
            self._have_attrs = True
        self.gts.append(
            _Boxes(
                gt_boxes[:, :3],
                gt_boxes[:, 3:6],
                gt_boxes[:, 6],
                gt_boxes[:, 7:9],
                gt_labels,
                attr=gt_attrs,
            )
        )
        self.ego_xys.append(
            None
            if ego_xy is None
            else np.asarray(ego_xy, np.float64).reshape(2)
        )

    # ------------------------------------------------------------------
    def _class_filter(
        self, boxes: _Boxes, cls_idx: int, cls_name: str, ego_xy=None
    ):
        rng = self.cfg.class_range.get(cls_name, 50.0)
        xy = boxes.xyz[:, :2]
        if ego_xy is not None:
            xy = xy - ego_xy
        keep = (boxes.label == cls_idx) & (
            np.linalg.norm(xy, axis=1) < rng
        )
        return keep

    def _accumulate(self, cls_idx: int, cls_name: str, dist_th: float):
        """One (class, threshold) PR sweep. Returns interpolated curves."""
        # gather all predictions of this class over all samples; GT of
        # the class is pre-grouped per sample ONCE (the devkit pre-groups
        # by sample token) — recomputing the filter per prediction entry
        # made full-val evaluation quadratically slow
        entries = []  # (score, sample_idx, pred_idx)
        g_sel = []  # per sample: GT indices of this class in range
        npos = 0
        for si, (p, g) in enumerate(zip(self.preds, self.gts)):
            ego = self.ego_xys[si]
            gmask = self._class_filter(g, cls_idx, cls_name, ego)
            g_sel.append(np.nonzero(gmask)[0])
            npos += int(gmask.sum())
            for pi in np.nonzero(
                self._class_filter(p, cls_idx, cls_name, ego)
            )[0]:
                entries.append((p.score[pi], si, pi))
        n_interp = 101
        empty = {
            "precision": np.zeros(n_interp),
            "confidence": np.zeros(n_interp),
            "trans_err": np.ones(n_interp),
            "scale_err": np.ones(n_interp),
            "orient_err": np.ones(n_interp),
            "vel_err": np.ones(n_interp),
            "attr_err": np.ones(n_interp),
            "max_recall_ind": -1,
            "npos": npos,
        }
        if npos == 0 or not entries:
            return empty
        entries.sort(key=lambda e: -e[0])

        taken = set()
        tp, fp, conf = [], [], []
        m_trans, m_scale, m_orient, m_vel, m_conf = [], [], [], [], []
        m_attr = []
        period = np.pi if cls_name == "barrier" else 2 * np.pi
        for score, si, pi in entries:
            p, g = self.preds[si], self.gts[si]
            best, best_d = -1, np.inf
            for gi in g_sel[si]:
                if (si, gi) in taken:
                    continue
                d = np.linalg.norm(p.xyz[pi, :2] - g.xyz[gi, :2])
                if d < best_d:
                    best, best_d = gi, d
            if best >= 0 and best_d < dist_th:
                taken.add((si, best))
                tp.append(1)
                fp.append(0)
                m_trans.append(best_d)
                m_scale.append(
                    1.0 - _aligned_iou(p.size[pi], g.size[best])
                )
                m_orient.append(
                    float(_yaw_diff(p.yaw[pi], g.yaw[best], period))
                )
                if cls_name not in ("barrier", "traffic_cone"):
                    m_vel.append(
                        float(np.linalg.norm(p.vel[pi] - g.vel[best]))
                    )
                else:
                    m_vel.append(np.nan)
                # devkit attr_acc: NaN when GT has no attribute, else
                # exact-match indicator
                gattr = str(g.attr[best])
                m_attr.append(
                    np.nan
                    if gattr == ""
                    else 1.0 - float(str(p.attr[pi]) == gattr)
                )
                m_conf.append(score)
            else:
                tp.append(0)
                fp.append(1)
            conf.append(score)

        tp = np.cumsum(tp).astype(np.float64)
        fp = np.cumsum(fp).astype(np.float64)
        prec = tp / (tp + fp)
        rec = tp / npos
        rec_interp = np.linspace(0, 1, n_interp)
        out = dict(empty)
        out["precision"] = np.interp(rec_interp, rec, prec, right=0)
        out["confidence"] = np.interp(rec_interp, rec, conf, right=0)
        out["max_recall_ind"] = int(
            np.floor(rec[-1] * (n_interp - 1) + 1e-9)
        )

        if m_conf:
            # cumulative-mean TP errors as a function of confidence,
            # re-sampled onto the recall grid via the confidence curve.
            # NaN handling mirrors the devkit's cummean exactly: nancumsum
            # over the FULL matched array with 0 where no valid entry has
            # been seen yet, interpolated over ALL match confidences —
            # dropping NaN rows first would left-clamp to the first valid
            # mean and bias mAAE/mAVE at high confidence
            def cm(v):
                v = np.asarray(v, np.float64)
                ok = ~np.isnan(v)
                if not ok.any():
                    return np.ones(n_interp)
                sums = np.nancumsum(v)
                counts = np.cumsum(ok).astype(np.float64)
                c = np.divide(
                    sums,
                    counts,
                    out=np.zeros_like(sums),
                    where=counts != 0,
                )
                cc = np.asarray(m_conf)
                return np.interp(out["confidence"], cc[::-1], c[::-1])

            out["trans_err"] = cm(m_trans)
            out["scale_err"] = cm(m_scale)
            out["orient_err"] = cm(m_orient)
            out["vel_err"] = cm(m_vel)
            out["attr_err"] = cm(m_attr)
        return out

    def _calc_ap(self, md) -> float:
        first = round(100 * self.cfg.min_recall) + 1
        prec = md["precision"][first:] - self.cfg.min_precision
        prec = np.clip(prec, 0, 1)
        return float(prec.mean()) / (1.0 - self.cfg.min_precision)

    def _calc_tp(self, md, key) -> float:
        first = round(100 * self.cfg.min_recall) + 1
        last = md["max_recall_ind"]
        if last < first:
            return 1.0
        return float(np.mean(md[key][first : last + 1]))

    def evaluate(self) -> dict:
        cfg = self.cfg
        aps = {}
        tp_errs = {
            k: {} for k in ("trans", "scale", "orient", "vel", "attr")
        }
        for cname in cfg.class_names:
            # labels index cfg.class_names — the same space add_sample
            # uses for attribute selection (for the default config this
            # IS the canonical 10-class nuScenes id)
            ci = list(cfg.class_names).index(cname)
            cls_aps = []
            for th in cfg.dist_ths:
                md = self._accumulate(ci, cname, th)
                cls_aps.append(self._calc_ap(md))
                if th == cfg.dist_th_tp:
                    # devkit per-class TP-metric skips (evaluate.py /
                    # detection config): traffic_cone has no
                    # attr/vel/orient, barrier no attr/vel
                    tp_errs["trans"][cname] = self._calc_tp(md, "trans_err")
                    tp_errs["scale"][cname] = self._calc_tp(md, "scale_err")
                    if cname != "traffic_cone":
                        tp_errs["orient"][cname] = self._calc_tp(
                            md, "orient_err"
                        )
                    if cname not in ("barrier", "traffic_cone"):
                        tp_errs["vel"][cname] = self._calc_tp(md, "vel_err")
                        if self._have_attrs:
                            tp_errs["attr"][cname] = self._calc_tp(
                                md, "attr_err"
                            )
            aps[cname] = float(np.mean(cls_aps))

        mean_ap = float(np.mean(list(aps.values())))
        m = {
            f"m{k}e": float(np.mean(list(v.values()))) if v else 1.0
            for k, v in tp_errs.items()
        }
        # NDS = (5*mAP + sum over 5 TP metrics of (1 - min(1, tp))) / 10.
        # Without GT attributes the AAE slot contributes its best-case
        # term (documented fallback for reference-format pkls that lack
        # attribute names); with them it is the devkit's real mAAE.
        attr_term = (
            max(1.0 - min(1.0, m["mattre"]), 0.0)
            if self._have_attrs
            else 1.0
        )
        tp_scores = [max(1.0 - min(1.0, m[f"m{k}e"]), 0.0) for k in
                     ("trans", "scale", "orient", "vel")]
        nds = (5.0 * mean_ap + sum(tp_scores) + attr_term) / 10.0
        out = {
            "mAP": mean_ap,
            "NDS": nds,
            "per_class_ap": aps,
            "mATE": m["mtranse"],
            "mASE": m["mscalee"],
            "mAOE": m["moriente"],
            "mAVE": m["mvele"],
        }
        if self._have_attrs:
            out["mAAE"] = m["mattre"]
        return out
