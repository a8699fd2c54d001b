"""Training loop (counterpart of graph_detr4d_tpu/train/trainer.py:
PrefetchIterator, MetricLogger and Trainer with resume, checkpoints, an
eval hook and a profiled window; one process a GPU).

    trainer = Trainer(cfg, state_dict, batch_iter, work_dir)
    trainer.resume()                        # from work_dir/checkpoints
    records = trainer.fit(total_steps=100, ckpt_every=50, log_interval=50)
    trainer.close()                         # or drop it: its threads stop

`batch_iter` yields host batches (dicts of numpy arrays, as
data/pipeline.py::build_batch and data/synthetic.py::synthetic_batch make
them). Input runs two stages ahead of the step, each on its own thread:
the first runs the host pipeline (decode, augmentation, collation); the
second casts the images for transfer (parallel/transfer.py) and copies
the batch to the card from pinned memory on its own CUDA stream. The step
waits on that copy's event. Metrics are summed on the device and fetched
once per log interval, averaged, and appended to
`work_dir/train_log.jsonl` with `iter_time` (s a step), `data_time` (the
host pipeline's s a batch, on its thread), `h2d_bytes` and `h2d_ms` (the
copy's device time, between events around the copies on its stream). The JAX logger also writes tensorboard; this one writes JSONL only
(ROADMAP Queue 3).

Under a process group (`mesh`, parallel/mesh.py) every rank runs a
Trainer on its share of each global batch (on a cam group, the transfer
stage keeps the rank's cameras: parallel/mesh.py::shard_batch). Rank 0's
weights are broadcast at the start; rank 0 alone writes the log and the
checkpoints, which hold every data rank's generator state; every rank
resumes from the same file and takes its own generator back (a
checkpoint of another data size leaves the generators as seeded).
"""

import json
import os
import queue
import threading
import time
import weakref
from typing import Callable, Iterable, List, Optional

import torch

from ..config import ModelConfig
from ..models.detector import GraphDETR4D
from ..parallel.mesh import Mesh, gather_states, replicate, shard_batch
from ..parallel.transfer import batch_bytes, cast_for_transfer, to_device
from ..utils.device import resolve_device
from .checkpoint import CheckpointManager
from .step import TrainStep

PREFETCH = 2  # batches each input stage runs ahead of the step


class MetricLogger:
    """JSONL metrics log: one flat record per logged step."""

    def __init__(self, work_dir: str):
        os.makedirs(work_dir, exist_ok=True)
        self.path = os.path.join(work_dir, "train_log.jsonl")

    def log(self, step: int, metrics: dict) -> dict:
        rec = {"step": int(step), **{k: float(v) for k, v in metrics.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec


class PrefetchIterator:
    """A daemon thread runs `it` up to `depth` items ahead of the consumer.

    An exception raised by `it` reaches the consumer: next() raises it
    where the items end, never ending the iteration quietly. close() stops
    the thread and joins it.
    """

    _DONE = object()

    def __init__(self, it: Iterable, depth: int = 2, name: str = "prefetch"):
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err = None
        self._finished = False

        def run():
            try:
                for item in it:
                    if not self._put(item):
                        return
            except BaseException as e:  # raised again on the consumer side
                self._err = e
            self._put(self._DONE)

        self._thread = threading.Thread(target=run, daemon=True, name=name)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def __iter__(self):
        return self

    def __next__(self):
        while not self._finished:
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                # a stopped producer delivers no end marker
                self._finished = not self._thread.is_alive() and self._q.empty()
                continue
            if item is self._DONE:
                self._finished = True
                if self._err is not None:
                    raise self._err
            else:
                return item
        raise StopIteration

    def stop(self):
        """Ask the thread to stop after the item it is producing."""
        self._stop.set()

    def close(self, timeout: float = 60.0):
        """Stop the thread and join it."""
        self.stop()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError(f"{self._thread.name} did not stop in {timeout} s")


def timed(it):
    """Yields (item, seconds its production took) for each item of it."""
    it = iter(it)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        yield item, time.perf_counter() - t0


class Trainer:
    """The model, its TrainStep, the input stages, checkpoints and logs.

    eval_fn(model) -> dict of metrics runs after each checkpoint save, its
    result logged at that step. profile_steps > 0 records a torch.profiler
    trace of that many steps, after the first step of this run, into
    `work_dir/profile/trace.json`, and its summary (span, device busy ms,
    device idle share) into `self.profile_summary`.

    The input threads hold no reference to the Trainer: close() stops
    them, and so does dropping the last reference to it.
    """

    def __init__(self, cfg: ModelConfig, state_dict, batch_iter: Iterable[dict],
                 work_dir: str, device="cuda", seed: int = 0,
                 eval_fn: Optional[Callable] = None, profile_steps: int = 0,
                 mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.work_dir = work_dir
        self.mesh = mesh if mesh is not None else Mesh()
        self.is_main = self.mesh.is_main
        model = GraphDETR4D(cfg, device=self.device)
        model.load_state_dict(state_dict, strict=True)
        replicate(model, self.mesh)
        self.train_step = TrainStep(model, cfg, seed=seed, mesh=self.mesh)
        self.logger = MetricLogger(work_dir)
        self.ckpt = CheckpointManager(os.path.join(work_dir, "checkpoints"), cfg)
        # read once here, before rank 0 can have saved anything (its first
        # step waits for every rank): every rank decides alike whether fit
        # saves at its end
        self._saved_step = self.ckpt.latest_step()
        self.eval_fn = eval_fn
        self.profile_steps = profile_steps
        self.profile_summary = None
        self.step = 0
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._in_flight = []  # (copy event, pinned host tensors)
        host = PrefetchIterator(timed(batch_iter), PREFETCH,
                                "trainer-host-pipeline")
        self._transfer = PrefetchIterator(
            _transfers(host, cfg.bf16, self.device, self._copy_stream,
                       self.mesh),
            PREFETCH, "trainer-transfer")
        self._close = weakref.finalize(self, _close_stages, self._transfer, host)

    @property
    def model(self):
        return self.train_step.model

    def _next_batch(self):
        """The next device batch, ordered after its copy on the step's
        stream, or None when the input has ended."""
        item = next(self._transfer, None)
        if item is None:
            return None, None
        dev, pinned, timing, events = item
        if events is not None:
            done = events[1]
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in dev.values():
                t.record_stream(stream)
            # a pinned buffer lives until its copy has completed
            self._in_flight = [(e, p) for e, p in self._in_flight
                               if not e.query()]
            self._in_flight.append((done, pinned))
        return dev, (timing, events)

    def state(self) -> dict:
        """The checkpoint's state; under a data group a collective (every
        data rank's generator state is gathered), so every rank calls it."""
        ts = self.train_step
        gens = gather_states(ts.generator.get_state(), self.mesh, self.device)
        return {"state_dict": self.model.state_dict(),
                "optimizer": ts.optimizer.state_dict(),
                "scheduler": ts.scheduler.state_dict(),
                "generators": {"train": gens[0], "train_ranks": gens}}

    def resume(self) -> int:
        """Restore the latest checkpoint of work_dir/checkpoints, if any:
        weights, AdamW and schedule, the generator and the step. Returns
        the step."""
        ckpt = self.ckpt.restore(map_location=self.device)
        if ckpt is None:
            return self.step
        ts = self.train_step
        self.model.load_state_dict(ckpt["state_dict"], strict=True)
        ts.optimizer.load_state_dict(ckpt["optimizer"])
        ts.scheduler.load_state_dict(ckpt["scheduler"])
        gens = ckpt["generators"]
        ranks = gens.get("train_ranks", [gens["train"]])
        if len(ranks) == self.mesh.data:
            ts.generator.set_state(ranks[self.mesh.data_index].cpu())
        # saved by another number of data ranks: each rank's generator
        # stays as its data rank seeded it
        self.step = self._saved_step = int(ckpt["step"])
        if ts.scheduler.last_epoch != self.step:
            raise RuntimeError(
                f"checkpoint step {self.step} but the schedule has taken "
                f"{ts.scheduler.last_epoch} steps")
        return self.step

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        # device activity only on the card: host-op tracing slows a
        # launch-bound step several times over
        acts = [ProfilerActivity.CUDA if self.device.type == "cuda"
                else ProfilerActivity.CPU]
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof_t0 = time.perf_counter()
        self._prof_steps = 0

    def _stop_profile(self):
        from torch.autograd import DeviceType

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        span_ms = 1e3 * (time.perf_counter() - self._prof_t0)
        self._prof.__exit__(None, None, None)
        out = os.path.join(self.work_dir, "profile")
        if self.is_main:
            os.makedirs(out, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(out, "trace.json"))
        busy_us = sum(
            getattr(e, "self_device_time_total", 0.0)
            for e in self._prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))
        self.profile_summary = {
            "steps": self._prof_steps, "span_ms": span_ms,
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e3 / span_ms,
        }
        self._prof = None
        self.profile_steps = 0

    def fit(self, total_steps: int, log_interval: int = 50,
            ckpt_every: Optional[int] = None) -> List[dict]:
        """Train until `total_steps` updates in all (or the batches run
        out). With `ckpt_every`, save every `ckpt_every` steps and at the
        end, running eval_fn after each save; None saves nothing. Returns
        the records logged by this call."""
        records, msum, count, t0 = [], None, 0, time.perf_counter()
        timings, steps_this_run = [], 0
        self._prof = None
        while self.step < total_steps:
            batch, timing = self._next_batch()
            if batch is None:
                break
            if self.profile_steps > 0 and self._prof is None and steps_this_run:
                self._start_profile()
            metrics = self.train_step.step(batch)
            self.step += 1
            steps_this_run += 1
            count += 1
            timings.append(timing)
            msum = metrics if msum is None else {
                k: msum[k] + metrics[k] for k in msum}
            if self._prof is not None:
                self._prof_steps += 1
            if self.step % log_interval == 0:
                keys = sorted(msum)
                # one device-to-host copy per interval
                packed = torch.stack([msum[k].float() for k in keys]).cpu()
                avg = {k: packed[i].item() / count for i, k in enumerate(keys)}
                avg["iter_time"] = (time.perf_counter() - t0) / count
                avg.update(_mean_timing(timings))
                if self.is_main:
                    records.append(self.logger.log(self.step, avg))
                msum, count, timings, t0 = None, 0, [], time.perf_counter()
            if self._prof is not None and self._prof_steps >= self.profile_steps:
                self._stop_profile()
                t0 = time.perf_counter()  # the trace's export is not a step
            if ckpt_every and self.step % ckpt_every == 0:
                self._checkpoint()
        if self._prof is not None:
            self._stop_profile()
        if ckpt_every and self._saved_step != self.step:
            self._checkpoint()
        return records

    def _checkpoint(self):
        self._saved_step = self.step
        state = self.state()
        if self.is_main:
            self.ckpt.save(self.step, state)
        if self.eval_fn is not None:
            # every rank evaluates (a cam group's forward is collective)
            results = self.eval_fn(self.model)
            if self.is_main:
                self.logger.log(self.step, results)

    def close(self):
        """Stop and join the input threads."""
        self._close()


def _transfers(host_iter, bf16: bool, device, stream, mesh: Mesh):
    """The second input stage: keep the rank's cameras, cast each host
    batch for transfer and copy it to the device on `stream`."""
    for batch, host_s in host_iter:
        batch = cast_for_transfer(shard_batch(batch, mesh), bf16)
        timing = {"data_time": host_s, "h2d_bytes": batch_bytes(batch)}
        dev, events, pinned = to_device(batch, device, stream)
        yield dev, pinned, timing, events


def _close_stages(*stages):
    for s in stages:
        s.stop()
    for s in stages:
        s.close()


def _mean_timing(timings) -> dict:
    """Mean data_time (s), h2d_ms and h2d_bytes over a log interval."""
    n = len(timings)
    out = {"data_time": sum(t["data_time"] for t, _ in timings) / n,
           "h2d_bytes": sum(t["h2d_bytes"] for t, _ in timings) / n}
    events = [e for _, e in timings if e is not None]
    if events:
        events[-1][1].synchronize()
        out["h2d_ms"] = sum(s.elapsed_time(e) for s, e in events) / len(events)
    return out
