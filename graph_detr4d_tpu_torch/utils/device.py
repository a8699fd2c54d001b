"""Device selection for the port's entry points, and the constant tensors
a forward reads."""

import functools

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.

    Entry points default to the card. Without CUDA they raise rather than
    quietly running on the host; only an explicit `device="cpu"` (what the
    CPU tests pass) selects the host.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the host"
        )
    return dev


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """`torch.tensor(values, dtype=dtype, device=device)`, made once per
    (values, dtype, device) and kept. A forward that reads its constants
    through this makes one host-to-device copy the first time and none
    after, so a CUDA graph can capture it. Made outside inference mode, so
    a training forward can save it for backward after an inference-mode
    forward made it. Callers must not write to it."""
    return _constant(tuple(values), dtype, torch.device(device))


@functools.cache
def _constant(values, dtype, device):
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)
