"""Training loop (counterpart of graph_detr4d_tpu/train/trainer.py's
Trainer.fit and MetricLogger, on one GPU).

    trainer = Trainer(cfg, state_dict, batch_iter, work_dir)
    records = trainer.fit(total_steps=100, log_interval=50)

`batch_iter` yields host batches (dicts of numpy arrays, as
data/synthetic.py::synthetic_batch makes them). Metrics are summed on the
device and fetched once per log interval, averaged, and appended to
`work_dir/train_log.jsonl` with the seconds per iteration.
"""

import json
import os
import time
from typing import Iterable, List

import torch

from ..config import ModelConfig
from ..models.detector import GraphDETR4D
from ..utils.device import resolve_device
from .step import TrainStep


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


class Trainer:
    def __init__(self, cfg: ModelConfig, state_dict, batch_iter: Iterable[dict],
                 work_dir: str, device="cuda", seed: int = 0):
        self.device = resolve_device(device)
        self.cfg = cfg
        model = GraphDETR4D(cfg, device=self.device)
        model.load_state_dict(state_dict, strict=True)
        self.train_step = TrainStep(model, cfg, seed=seed)
        self.batch_iter = iter(batch_iter)
        self.logger = MetricLogger(work_dir)
        self.step = 0

    @property
    def model(self):
        return self.train_step.model

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def fit(self, total_steps: int, log_interval: int = 50) -> List[dict]:
        """Train until `total_steps` updates in all (or the batches run
        out). Returns the records logged by this call."""
        records, msum, count, t0 = [], None, 0, time.perf_counter()
        while self.step < total_steps:
            batch = next(self.batch_iter, None)
            if batch is None:
                break
            metrics = self.train_step.step(self._to_device(batch))
            self.step += 1
            count += 1
            msum = metrics if msum is None else {
                k: msum[k] + metrics[k] for k in msum}
            if self.step % log_interval == 0:
                keys = sorted(msum)
                # one device-to-host copy per interval
                packed = torch.stack([msum[k].float() for k in keys]).cpu()
                avg = {k: packed[i].item() / count for i, k in enumerate(keys)}
                avg["iter_time"] = (time.perf_counter() - t0) / count
                records.append(self.logger.log(self.step, avg))
                msum, count, t0 = None, 0, time.perf_counter()
        return records
