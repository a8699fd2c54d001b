"""GridMask structured dropout for training (counterpart of
graph_detr4d_tpu/models/grid_mask.py; reference models/utils/grid_mask.py
as the detector builds it: GridMask(True, True, rotate=1, offset=False,
ratio=0.5, mode=1, prob=0.7)). rotate=1 never rotates, so the mask is
modular striping: a pixel is kept iff it lies on an h-strip or a w-strip.

Split in two so that a test can feed the values JAX drew:
`grid_mask_params` draws (apply, d, l, st_h, st_w) from an explicit
`torch.Generator` as 0-d tensors on its device (no host sync), and
`apply_grid_mask` applies them.
"""

import torch


def grid_mask_params(generator: torch.Generator, H: int, prob: float = 0.7,
                     ratio: float = 0.5):
    """(apply, d, l, st_h, st_w): apply with probability `prob`; period d
    uniform in [2, H); strip width l = clip(int(d * ratio + 0.5), 1, d - 1);
    offsets uniform in [0, d)."""
    dev = generator.device
    apply = torch.rand((), generator=generator, device=dev) < prob
    d = torch.randint(2, H, (), generator=generator, device=dev)
    l = (d.float() * ratio + 0.5).long().clamp(min=1)
    l = torch.minimum(l, d - 1)
    offsets = torch.rand(2, dtype=torch.float64, generator=generator,
                         device=dev)
    st = torch.minimum((offsets * d).long(), d - 1)
    return apply, d, l, st[0], st[1]


def apply_grid_mask(images: torch.Tensor, d, l, st_h, st_w, apply):
    """images (B, N, H, W, C) times the strip mask where `apply`; the
    parameters are ints or 0-d tensors."""
    _, _, H, W, _ = images.shape
    ys = torch.arange(H, device=images.device)
    xs = torch.arange(W, device=images.device)
    keep = (((ys - st_h) % d) < l)[:, None] | (((xs - st_w) % d) < l)[None, :]
    keep = keep | ~torch.as_tensor(apply, device=images.device)
    return images * keep.to(images.dtype)[None, None, :, :, None]
