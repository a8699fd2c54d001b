"""Checkpoints: save, rotate, restore (counterpart of
graph_detr4d_tpu/train/checkpoint.py, with torch.save in place of orbax).

One file a step, `<directory>/step_<step>.pth`, the `max_to_keep` newest
kept (the reference's CheckpointHook max_keep_ckpts=3,
configs/...12e.py:222). A full checkpoint holds:

  state_dict   the model's weights under the reference's names, so it
               loads wherever an upstream checkpoint loads;
  optimizer    the AdamW state; scheduler: the LambdaLR state;
  step         updates taken; generators: the training generator's
               state (grid mask and dropout draw from it);
  meta         {'step', 'config' (the ModelConfig as a dict), 'metrics'}.

`restore` is the reference's `--resume-from` (the whole state),
`load_weights` its `load_from` (weights only, a fresh optimizer);
`save_weights` writes weights and meta only (publish_model).
"""

import os
import re
from dataclasses import asdict
from typing import Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pth$")


class CheckpointManager:
    def __init__(self, directory: str, cfg=None, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.cfg = cfg
        self.max_to_keep = max_to_keep

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pth")

    def steps(self):
        """Saved steps, oldest first."""
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                      os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _meta(self, step: int, metrics: Optional[dict]) -> dict:
        meta = {"step": int(step)}
        if self.cfg is not None:
            meta["config"] = asdict(self.cfg)
        if metrics:
            meta["metrics"] = {k: float(v) for k, v in metrics.items()}
        return meta

    def _write(self, step: int, payload: dict) -> str:
        # write then rename: a reader never sees a half-written file
        path = self.path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def save(self, step: int, state: dict, metrics: Optional[dict] = None):
        """state: 'state_dict', 'optimizer', 'scheduler', 'generators'
        (what Trainer.state() returns); tensors are saved on the CPU."""
        payload = {k: _to_cpu(v) for k, v in state.items()}
        payload["step"] = int(step)
        payload["meta"] = self._meta(step, metrics)
        return self._write(step, payload)

    def save_weights(self, step: int, state_dict):
        """Weights only (publish_model semantics: no optimizer)."""
        return self._write(step, {"state_dict": _to_cpu(state_dict),
                                  "meta": self._meta(step, None)})

    def restore(self, step: Optional[int] = None, map_location="cpu"):
        """The whole checkpoint dict of `step` (the latest when None), or
        None when the directory holds none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self.path(step), map_location=map_location,
                          weights_only=True)

    def load_weights(self, step: Optional[int] = None, map_location="cpu"):
        """`load_from` semantics: the state_dict only, or None."""
        ckpt = self.restore(step, map_location)
        return None if ckpt is None else ckpt["state_dict"]


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return type(tree)((k, _to_cpu(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree
