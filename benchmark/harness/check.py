"""Whether what the timed path produced is correct: the numbers that are
compared with the cell's limits.

The program's side is what the window itself produced: the head's output
(every decoder layer's class logits and box codes) of the sampled
requests and their served answers, and the head's input of the
feature-sampled requests (the new frame's features and, streaming, the
cached previous frame's: the state the stream carries), captured by
hooks on the model's head. The reference's side is worked out again
from the seed's weights and inputs by the configuration's plain float32
reference,
frame by frame, the previous frame's features included: nothing the
program made enters it. Numbers, each the worst over its sample:

  overflow  in-view queries the per-camera compaction dropped, summed
            over every request of the window (exact: 0)
  answer    the served answer against the reference decode of the
            head output the program computed in the window: boxes,
            scores, labels and validity, largest absolute difference
            (exact: decode and the copy back add no error)
  features  |f - f_ref| / |f_ref| of each level of the head's input
  logits    |c - c_ref| / |c_ref| of each decoder layer's class logits
  boxes     |b - b_ref| / |b_ref| of each decoder layer's box codes
"""

import torch

from reference.common import Ref, nms_free_decode


def rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


class ReferenceRun:
    """The reference over the requests of a run, one pool frame's
    features computed once."""

    def __init__(self, ref_mod, model, sd, traffic, precision="fp32"):
        self.mod, self.model, self.traffic = ref_mod, model, traffic
        self.ref = Ref(sd, precision)
        self.device = next(iter(sd.values())).device
        self._feats = {}

    def frame_feats(self, p: int):
        if p not in self._feats:
            images = torch.as_tensor(self.traffic.frames[p][None], device=self.device)
            self._feats[p] = self.mod.features(self.ref, self.model, images)
        return self._feats[p]

    def request(self, i: int):
        """(the head's input features, class logits, box codes) of request
        i: the features of the new frame's cameras, then of the previous
        frame's (streaming: the frame the stream's cache holds)."""
        t = self.traffic
        p = t.frame(i)
        cur = self.frame_feats(p)
        if t.starts_scene(i):
            prev = cur
        else:
            prev = self.frame_feats(t.previous(p))
        feats = [torch.cat([c, q], dim=1) for c, q in zip(cur, prev)]
        l2i = torch.as_tensor(t.lidar2img(i), device=self.device)
        extras = {k: torch.full((1,), float(v), device=self.device)
                  for k, v in t.extra_values.items()}
        cls, box = self.mod.forward_feats(self.ref, self.model, feats, l2i, extras)
        return feats, cls, box


def served_gap(answer: dict, cls_last, box_last, coder: dict) -> float:
    """Largest difference between a served answer (numpy, batch 1) and the
    reference decode of the program's own last-layer output."""
    want = nms_free_decode(cls_last, box_last, coder["max_num"],
                           coder["post_center_range"])
    gap = 0.0
    for k in ("bboxes", "scores", "labels", "valid"):
        got = torch.as_tensor(answer[k][0]).to(want[k].device).float()
        gap = max(gap, float((got - want[k].float()).abs().max()))
    return gap


def compare(program: dict, reference: ReferenceRun, coder: dict,
            answers: bool = True) -> dict:
    """The numbers of `program`: {'overflow', 'answers' {i: answer},
    'heads' {i: (cls, box)}, 'features' {i: [levels]}}; without
    `answers` the served answers are not compared."""
    out = {"overflow": float(program["overflow"]), "answer": 0.0,
           "features": 0.0, "logits": 0.0, "boxes": 0.0}
    for i in sorted(set(program["heads"]) | set(program["features"])):
        feats, cls, box = reference.request(i)
        if i in program["heads"]:
            pcls, pbox = program["heads"][i]
            out["logits"] = max(out["logits"], max(
                rel(pcls[l, 0], cls[l, 0]) for l in range(cls.shape[0])))
            out["boxes"] = max(out["boxes"], max(
                rel(pbox[l, 0], box[l, 0]) for l in range(box.shape[0])))
            if answers:
                out["answer"] = max(out["answer"], served_gap(
                    program["answers"][i], pcls[-1, 0], pbox[-1, 0], coder))
        if i in program["features"]:
            out["features"] = max(out["features"], max(
                rel(a, b) for a, b in zip(program["features"][i], feats)))
    return out
