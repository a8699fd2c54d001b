"""Host -> device transfer of a host batch (counterpart of
graph_detr4d_tpu/parallel/mesh.py::cast_for_transfer, on one GPU).

    batch = cast_for_transfer(build_batch(...), cfg.bf16)
    dev, (start, done), pinned = to_device(batch, device, stream)

Under a bf16 config float images are cast to bf16 on the host, which
halves the bytes of the copy and changes no result: the backbone casts
its input to bf16 anyway, and the grid mask multiplies by 0 or 1. uint8
images (device_normalize's raw pixels) already ship at the least width.
"""

import numpy as np
import torch


def cast_for_transfer(batch: dict, bf16: bool) -> dict:
    """The batch with float images as a bf16 tensor under `bf16`; every
    other entry, and uint8 or already-bf16 images, unchanged."""
    imgs = batch.get("images")
    if not bf16 or imgs is None or imgs.dtype in (
            np.uint8, torch.uint8, torch.bfloat16):
        return batch
    imgs = torch.as_tensor(np.ascontiguousarray(imgs)
                           if isinstance(imgs, np.ndarray) else imgs)
    return {**batch, "images": imgs.to(torch.bfloat16)}


def batch_bytes(batch: dict) -> int:
    """Bytes a batch's tensors and arrays occupy (what a copy moves)."""
    return sum(int(torch.as_tensor(v).nbytes) for v in batch.values())


def to_device(batch: dict, device: torch.device, stream=None):
    """Copy a host batch (numpy arrays or CPU tensors) to `device`.

    On a CUDA device each entry is pinned and copied with non_blocking on
    `stream` (the current stream when None). Returns (the device batch,
    (start, done): timing events recorded on `stream` just before and
    after the copies, the pinned host tensors). The caller makes its
    stream wait on `done` before using the batch and keeps the pinned
    tensors until `done` has completed; start.elapsed_time(done) is the
    copy's device time. On the CPU the events are None and nothing is
    pinned.
    """
    host = {k: torch.as_tensor(v) for k, v in batch.items()}
    if device.type != "cuda":
        return {k: v.to(device) for k, v in host.items()}, None, []
    pinned = {k: v.pin_memory() for k, v in host.items()}
    stream = stream or torch.cuda.current_stream(device)
    start, done = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.cuda.stream(stream):
        start.record(stream)
        dev = {k: v.to(device, non_blocking=True) for k, v in pinned.items()}
        done.record(stream)
    return dev, (start, done), list(pinned.values())
