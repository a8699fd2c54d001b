"""The serving driver of the MP configuration: drivers/serve.py, whose
set-up, warm-up, requests, window and numbers it reuses, with `logits`
and `boxes` compared where a query graph that differs by rounding cannot
move them.

MP builds a k-nearest-neighbour graph over the queries' reference points
in every decoder layer. The choice of the k-th neighbour is
discontinuous: where the k-th and (k+1)-th distances nearly tie, the
program's bfloat16 arithmetic and the reference's float32 can pick
differently. That row then samples another neighbour and its box moves,
the rows that take it as a neighbour sample at its moved point, and the
next layer's graph differs in rows whose choice is no near-tie at all.
Past the first layer a sound run's logits and boxes differ from the
reference's by as much as the float8 control's, over all rows and over
the rows whose graph agreed in every earlier layer alike (PERF.md
section 2).

In the first layer the reference points come from the query table alone,
the same on both sides up to rounding. The window keeps the program's
first-layer graph of every request (models/transformer.py::
graph_neighbours, its first call of the request, wrapped while the
window lasts); the reference builds its own from its own points
(reference/mp.py `first_reference_points`, `query_graph`). Nothing of
the program's enters the reference. A row is set aside when its
neighbour set differs from the reference's by a near-tie: every
neighbour the program chose lies within NEAR_TIE of the reference's k-th
nearest squared distance. A row whose set differs otherwise stays, and
so does what its wrong neighbours do to its output. The numbers (drivers/serve.py's others unchanged):

  logits  |c - c_ref| / |c_ref| of the first decoder layer's class logits
          over the rows not set aside, the worst over the sampled
          requests
  boxes   the same of the first layer's box codes

Each reads 1.0 where the program kept no graph of a sampled request,
where more than MAX_SET_ASIDE of a request's rows are set aside, or
where any later layer's output over all rows differs from the
reference's by more than GROSS: the later layers are held to gross
faults only.
"""

import gc
import importlib

import torch

from drivers import serve
from drivers.serve import send, setup, warm  # noqa: F401  (the driver's API)
from harness import check as compare
from reference.common import strict_float32

GRAPH_MODULE = "graph_detr4d_tpu_torch.models.transformer"
NEAR_TIE = 0.2
MAX_SET_ASIDE = 0.25
GROSS = {"logits": 0.3, "boxes": 0.15}


def window(run, seconds):
    """serve.window with the program's first-layer graph of each request,
    (1, Q, k) indices, kept in run.graphs."""
    mod = importlib.import_module(GRAPH_MODULE)
    real = getattr(mod, "graph_neighbours", None)
    run.graphs = {}
    if real is None:
        return serve.window(run, seconds)

    def kept(ref, k):
        idx = real(ref, k)
        cap = run.capture
        if cap is not None and cap.index >= 0:
            run.graphs.setdefault(cap.index, idx)
        return idx

    mod.graph_neighbours = kept
    try:
        return serve.window(run, seconds)
    finally:
        mod.graph_neighbours = real


class KeptReferenceRun(compare.ReferenceRun):
    """harness/check.py's ReferenceRun that keeps each request's head
    output: kept[i] = (cls, box)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.kept = {}

    def request(self, i):
        feats, cls, box = super().request(i)
        self.kept[i] = (cls, box)
        return feats, cls, box


def first_graph(ref_mod, model, ref):
    """(points (1, Q, 3), graph (1, Q, k)) of the reference's first
    decoder layer, the same for every request."""
    pts = ref_mod.first_reference_points(ref, model)
    return pts, ref_mod.query_graph(pts, model["head"]["num_neighbors"])


def check(run):
    """serve.check with `logits` and `boxes` as above."""
    picks = serve.check_sample(run.traffic_spec, run.traffic.entry, run.requests,
                               run.seed)
    program_out = serve.program_side(run.captured, picks)
    graphs = {i: run.graphs.get(i) for i in picks}
    run.captured = run.engine = run.model = run.graphs = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    strict_float32()
    ref_run = KeptReferenceRun(run.ref_mod, run.model_dict, run.sd, run.traffic)
    with torch.no_grad():
        numbers = compare.compare(program_out, ref_run, run.model_dict["coder"])
        numbers.update(head_numbers(program_out["heads"], graphs, ref_run.kept,
                                    *first_graph(run.ref_mod, run.model_dict,
                                                 ref_run.ref)))
    return numbers


def head_numbers(heads, graphs, kept, pts, want):
    """{'logits', 'boxes'} of the program's head outputs {i: (cls, box)}
    and first-layer graphs {i: (1, Q, k) or None} against the
    reference's kept[i] (KeptReferenceRun) and its first layer's points
    and graph (`first_graph`)."""
    out = {"logits": 0.0, "boxes": 0.0}
    for i, outputs in heads.items():
        if graphs.get(i) is None:
            return {"logits": 1.0, "boxes": 1.0}
        aside = set_aside(graphs[i], pts, want)[0]
        for n, (got, ref) in zip(out, zip(outputs, kept[i])):
            later = max((compare.rel(got[l], ref[l])
                         for l in range(1, ref.shape[0])), default=0.0)
            if float(aside.float().mean()) > MAX_SET_ASIDE or later > GROSS[n]:
                out[n] = 1.0
            else:
                out[n] = max(out[n], compare.rel(got[0, 0][~aside],
                                                 ref[0, 0][~aside]))
    return out


def set_aside(idx, pts, want):
    """(B, Q) bool: the rows whose neighbour set idx (B, Q, k) differs
    from the reference's graph want by a near-tie, in the squared
    distances between the reference's points pts (B, Q, 3)."""
    idx = idx.to(want.device).long()
    differs = (idx.sort(-1).values != want.sort(-1).values).any(-1)
    d2 = ((pts[:, :, None, :] - pts[:, None, :, :]) ** 2).sum(-1)
    kth = d2.gather(-1, want).amax(-1)
    return differs & (d2.gather(-1, idx).amax(-1) <= (1.0 + NEAR_TIE) * kth)
