"""The serving driver: seeded weights into the program's serve.Engine, one
car's requests made by harness/traffic.py, and the check of what the
window served against the configuration's plain reference
(harness/check.py).

A traffic file names it with "driver": "serve" and holds the parameters
harness/traffic.py documents. One client sends batch-1 requests back to
back (closed loop): the end-to-end metric is frames_per_s, the rig frames
answered over the window's seconds.
"""

import gc

import numpy as np
import torch

import reference
from harness import check as compare
from harness.cell import closed_loop
from harness.traffic import Traffic
from harness.weights import make_state_dict
from reference.common import strict_float32


def setup(run):
    from graph_detr4d_tpu_torch.serve import Engine

    run.ref_mod = reference.load(run.config["reference"])
    run.sd = make_state_dict(run.ref_mod.param_specs(run.model_dict),
                             run.seed % 2 ** 64, run.device)
    run.engine = (run.program or Engine)(run.cfg, run.sd, device=run.device)
    run.model = run.engine.model
    run.traffic = Traffic(run.traffic_spec, run.model_dict,
                          run.config.get("extras", {}), run.seed, run.device)
    run.extras = run.traffic.extras(run.engine.extras_spec)
    run.capture = None


def warm(run):
    for i in range(run.traffic_spec["warmup_requests"]):
        send(run, i)
    run.traffic.reset(run.engine)
    run.sync()


def send(run, i):
    cap = run.capture
    if cap is not None:
        cap.index = i
    answer = run.traffic.call(run.engine, i, run.extras)
    if cap is not None:
        cap.answer(i, answer)


def window(run, seconds):
    run.capture = Capture(run.model, feature_sample(run.traffic_spec, run.seed))
    closed_loop(run, seconds)
    run.capture.close()
    run.captured, run.capture = run.capture, None
    return {"frames_per_s": run.requests / run.window_s}


def check(run):
    """The program's side taken, its state freed, then the reference."""
    picks = check_sample(run.traffic_spec, run.traffic.entry, run.requests, run.seed)
    program_out = program_side(run.captured, picks)
    run.captured = run.engine = run.model = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    strict_float32()
    ref_run = compare.ReferenceRun(run.ref_mod, run.model_dict, run.sd, run.traffic)
    with torch.no_grad():
        return compare.compare(program_out, ref_run, run.model_dict["coder"])


class Capture:
    """Hooks on the model that keep what the window produced for the
    check: the head's input (the new frame's features and, streaming,
    the cached frame's) of the feature sample, the head's outputs of
    every request, and every served answer."""

    def __init__(self, model, feature_sample):
        self.index = -1
        self.heads, self.features, self.answers = {}, {}, {}
        self.overflow = 0.0
        self.feature_sample = set(feature_sample)
        head = model.pts_bbox_head
        self.handles = [head.register_forward_pre_hook(self._head_input),
                        head.register_forward_hook(self._head)]

    def _head_input(self, module, args):
        if self.index in self.feature_sample:
            self.features[self.index] = list(args[0])

    def _head(self, module, args, out):
        self.heads[self.index] = (out["all_cls_scores"], out["all_bbox_preds"])

    def answer(self, i, answer):
        self.answers[i] = answer
        self.overflow += float(answer["cam_overflow"])

    def close(self):
        for h in self.handles:
            h.remove()
        self.index = -1


def feature_sample(spec, seed):
    """The requests among the first `feature_window` whose head input the
    check keeps, drawn from the seed before the window."""
    rng = np.random.default_rng([seed, 2])
    return {int(i) for i in rng.choice(spec["feature_window"],
                                       spec["feature_requests"], replace=False)}


def check_sample(spec, entry, done, seed):
    """The requests whose head output and answer the check compares, drawn
    from the seed among the `done` the window finished: a scene's first
    request (no cached frame) and others."""
    rng = np.random.default_rng([seed, 3])
    n = min(spec["check_requests"], done)
    picks = set()
    if entry == "infer_stream":
        picks.add(int(rng.choice(np.arange(0, done, spec["scene_frames"]))))
    rest = [i for i in range(done) if i not in picks]
    picks |= {int(i) for i in rng.choice(rest, n - len(picks), replace=False)}
    return sorted(picks)


def program_side(capture, picks):
    """What the check reads of the program: the sample's head outputs and
    answers, every request's overflow, the kept head inputs."""
    return {"overflow": capture.overflow,
            "heads": {i: capture.heads[i] for i in picks},
            "answers": {i: capture.answers[i] for i in picks},
            "features": capture.features}
