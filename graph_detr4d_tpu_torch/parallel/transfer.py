"""Host -> device transfer of a host batch (counterpart of
graph_detr4d_tpu/parallel/mesh.py::cast_for_transfer, on one GPU), and
of a server's requests.

    batch = cast_for_transfer(build_batch(...), cfg.bf16)
    dev, (start, done), pinned = to_device(batch, device, stream)

    staging = StagedCopy(device)          # one a server, shared by threads
    dtype = host_cast(images.dtype, cfg.bf16, cfg.device_normalize)
    images = staging(images, dtype)

Under a bf16 config float images are cast to bf16 on the host, which
halves the bytes of the copy and changes no result: the backbone casts
its input to bf16 anyway, and the grid mask multiplies by 0 or 1. uint8
images (device_normalize's raw pixels) already ship at the least width.
"""

import threading

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


def host_cast(dtype, bf16: bool, device_normalize: bool):
    """The dtype a model's images cross to the device in: bfloat16 where
    the model's first operation on them is that cast (a bf16 config,
    float32 images, not device_normalize, which normalises in float32
    first), else their own. The CPU's cast rounds to nearest even as the
    CUDA cast does, so the device receives the same bits; another float
    dtype keeps its own, since a cast on the host could round twice."""
    if bf16 and not device_normalize and dtype == torch.float32:
        return torch.bfloat16
    return dtype


def host_tensor(x):
    """x (a tensor, a numpy array or what np.asarray takes) as a tensor,
    viewing a numpy array's memory where torch can (not with negative
    strides, which are copied first)."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    if any(s < 0 for s in x.strides):
        x = np.ascontiguousarray(x)
    return torch.from_numpy(x)


class StagedCopy:
    """Host -> device copies through reused pinned buffers (serve.Engine's
    request inputs).

    `staging(x, dtype)` returns x (a host tensor or numpy array) on the
    device in `dtype`. On a CUDA device x is written (cast) into a pinned
    buffer of its shape and `dtype` in one pass over torch's intra-op
    threads, then copied with non_blocking on the device's current
    stream, which orders the caller's work after the copy; nothing else
    waits for it.

    A buffer is made the first time its (shape, dtype) is seen and kept
    for the object's life. A call holds its buffer alone, so threads may
    share the object; a buffer is written again only after the event
    recorded behind its last copy has completed. Nothing is kept of the
    caller's memory. On the CPU, or for x already on a device, this is
    `x.to(device, dtype)`: nothing is pinned (`pinned` False).
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.pinned = device.type == "cuda"
        self._free = {}  # (shape, dtype) -> [(buffer, event of its copy)]
        self._lock = threading.Lock()

    def __call__(self, x, dtype):
        x = host_tensor(x)
        if not self.pinned or x.device.type != "cpu":
            return x.to(self.device, dtype)
        buf = self._acquire(tuple(x.shape), dtype)
        try:
            buf.copy_(x)
            out = buf.to(self.device, non_blocking=True)
        finally:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            with self._lock:
                self._free.setdefault((tuple(x.shape), dtype), []).append(
                    (buf, done))
        return out

    def _acquire(self, shape, dtype):
        with self._lock:
            free = self._free.get((shape, dtype))
            buf, done = free.pop() if free else (None, None)
        if buf is None:
            with torch.inference_mode(False):  # writable in any mode
                return torch.empty(shape, dtype=dtype, pin_memory=True)
        done.synchronize()
        return buf
