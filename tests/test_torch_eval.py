"""The port's nuScenes evaluator and submission writer against the JAX
package's, on the CPU: the same boxes give the same metrics (NaN cases
included: classes with no GT or no predictions, GT without attributes,
velocity and attribute skips) and byte-equal results_nusc.json."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from graph_detr4d_tpu.eval import nuscenes_metrics as jax_metrics  # noqa: E402
from graph_detr4d_tpu.eval import submission as jax_sub  # noqa: E402
from graph_detr4d_tpu_torch.eval import nuscenes_metrics as port_metrics  # noqa: E402
from graph_detr4d_tpu_torch.eval import submission as port_sub  # noqa: E402

ATTRS = ("", "vehicle.moving", "vehicle.parked", "pedestrian.moving",
         "pedestrian.standing", "cycle.with_rider", "cycle.without_rider")


def scene(rng, n_gt, n_classes=10):
    """GT boxes (n, 9), labels, attribute names, and predictions made from
    them: near matches, far misses, duplicates and false positives."""
    gt = np.concatenate([
        rng.uniform(-55, 55, (n_gt, 2)), rng.uniform(-2, 1, (n_gt, 1)),
        rng.uniform(0.4, 5.0, (n_gt, 3)), rng.uniform(-np.pi, np.pi, (n_gt, 1)),
        rng.randn(n_gt, 2) * 3], 1)
    labels = rng.randint(0, n_classes, n_gt)
    attrs = np.array([ATTRS[k] for k in rng.randint(0, len(ATTRS), n_gt)],
                     object)
    pick = rng.rand(n_gt) < 0.7
    pred = gt[pick] + np.concatenate([
        rng.randn(pick.sum(), 3) * rng.choice([0.2, 1.5, 5.0], (pick.sum(), 1)),
        rng.randn(pick.sum(), 6) * 0.2], 1)
    plabels = labels[pick].copy()
    flip = rng.rand(len(plabels)) < 0.1
    plabels[flip] = rng.randint(0, n_classes, flip.sum())
    dup = pred[: max(1, len(pred) // 4)] + 0.05
    fp = gt[: rng.randint(0, 4)] + 30.0
    pred = np.concatenate([pred, dup, fp])
    plabels = np.concatenate([plabels, plabels[: len(dup)],
                              rng.randint(0, n_classes, len(fp))])
    return gt, labels, attrs, pred, plabels, rng.rand(len(pred))


SETTINGS = {
    "plain": dict(),
    "attrs": dict(attrs=True),
    "ego": dict(attrs=True, ego=True),
    "bike_racks": dict(attrs=True, ego=True, racks=True),
    "two_classes": dict(classes=("car", "pedestrian")),
    "sparse": dict(attrs=True, n_gt=2, samples=2),
}


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_evaluator_matches_jax(setting):
    kw = SETTINGS[setting]
    rng = np.random.RandomState(len(setting))
    classes = kw.get("classes")
    evs = []
    for mod in (port_metrics, jax_metrics):
        cfg = (mod.DetectionConfig(class_names=classes) if classes
               else mod.DetectionConfig())
        evs.append(mod.DetectionEvaluator(cfg))
    n_classes = len(classes) if classes else 10
    for s in range(kw.get("samples", 5)):
        gt, labels, attrs, pred, plabels, scores = scene(
            rng, kw.get("n_gt", 25), n_classes)
        if s == 1:  # a sample with no predictions
            pred, plabels, scores = np.zeros((0, 9)), np.zeros(0, int), np.zeros(0)
        extra = {}
        if kw.get("attrs"):
            extra["gt_attrs"] = attrs
        if kw.get("ego"):
            extra["ego_xy"] = rng.randn(2)
        if kw.get("racks"):
            racks = np.concatenate([gt[:3, :3], np.full((3, 3), 6.0),
                                    gt[:3, 6:7]], 1)
            extra["bike_racks"] = racks
        for ev in evs:
            ev.add_sample(pred, plabels, scores, gt, labels, **extra)
    ours, theirs = (ev.evaluate() for ev in evs)
    np.testing.assert_equal(ours, theirs)
    assert set(ours) == set(theirs)
    assert ("mAAE" in ours) == bool(kw.get("attrs"))


def test_evaluator_edge_cases_match_jax():
    """No sample at all; GT only; predictions only; one perfect match."""
    box = np.array([[10.0, 0, 0, 2, 4, 1.5, 0.3, 1.0, 0.0]])
    for adds in ([], [(np.zeros((0, 9)), [], [], box, [0])],
                 [(box, [0], [0.9], np.zeros((0, 9)), [])],
                 [(box, [0], [0.9], box, [0])]):
        evs = [m.DetectionEvaluator() for m in (port_metrics, jax_metrics)]
        for a in adds:
            for ev in evs:
                ev.add_sample(*(np.asarray(x) for x in a))
        np.testing.assert_equal(evs[0].evaluate(), evs[1].evaluate())


def test_select_attribute_and_ranges_match_jax():
    assert port_sub.CLASS_RANGE == jax_sub.CLASS_RANGE
    assert port_sub.DEFAULT_ATTRIBUTE == jax_sub.DEFAULT_ATTRIBUTE
    for name in list(port_sub.CLASS_RANGE) + ["unknown"]:
        for v in ((0.0, 0.0), (0.15, 0.14), (0.3, 0.0), (-2.0, 1.0)):
            assert port_sub.select_attribute(name, v) == \
                jax_sub.select_attribute(name, v)


def test_submission_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    per_sample = [{}, {}]
    for s in range(3):
        q1, q2 = (q / np.linalg.norm(q) for q in rng.randn(2, 4))
        info = {"token": f"tok{s}", "lidar2ego_rotation": q1,
                "lidar2ego_translation": rng.randn(3),
                "ego2global_rotation": q2,
                "ego2global_translation": rng.randn(3) * 500}
        _, _, _, boxes, labels, scores = scene(rng, 30)
        for out, mod in zip(per_sample, (port_sub, jax_sub)):
            out[info["token"]] = mod.boxes_to_nusc_annos(
                boxes.astype(np.float32), scores.astype(np.float32),
                labels.astype(np.int32), info)
    assert per_sample[0] == per_sample[1]
    assert sum(len(v) for v in per_sample[0].values()) > 0
    paths = [mod.write_submission(out, str(tmp_path / name))
             for out, mod, name in zip(per_sample, (port_sub, jax_sub),
                                       ("port", "jax"))]
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
