"""The least time the chip needs for one call of K1 (multi-scale
deformable attention) and K2 (the modulated deformable convolution)
forward, worked out from the call's arguments.

Frozen copies of chip_smoke.py's bound functions (bilinear_corners
:684-693, touched_value_rows :737-756, msda_bound_ms :759-774,
dcn_peak_flops :867-868, dcn_bound_ms :871-884; the backward bounds,
:777-794 and :887-899, come with the cell that reads them): each input
read once and each output written once over HBM bandwidth, or the
operations over the rate of their type, whichever is longer. The work is
read from the arguments, not from which kernel ran, so a later kernel is
held to the same bound. Peaks: NVIDIA's H100 SXM data sheet, dense, 700 W.
"""

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TENSOR_FLOPS = 989e12


def bilinear_corners(x, y, H, W):
    """Integer corners and bilinear weights (zero outside) of samples at
    pixel coordinates (x, y)."""
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        xx, yy = x0 + dx, y0 + dy
        w = (fy if dy else 1 - fy) * (fx if dx else 1 - fx)
        inb = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        yield xx, yy, w * inb


def touched_value_rows(value, loc, attn, index, need_attn, levels):
    """(distinct value rows, corner count) that K1's samples of the
    selected queries (index None: every query) read: in-image corners, and
    with need_attn only those whose attention weight is nonzero."""
    BN, S, heads, hd = value.shape
    rows = torch.arange(BN, device=value.device)[:, None]
    if index is not None:
        loc, attn = loc[rows, index], attn[rows, index]
    R, P = loc.shape[1], loc.shape[4]
    bn = rows[:, :, None, None].expand(BN, R, heads, P)
    h = torch.arange(heads, device=value.device)[None, None, :, None]
    touched, nnz, start = [], 0, 0
    for lvl, (H, W) in enumerate(levels):
        x = loc[:, :, :, lvl, :, 0] * W - 0.5
        y = loc[:, :, :, lvl, :, 1] * H - 0.5
        a = attn[:, :, :, lvl]
        for xx, yy, w in bilinear_corners(x, y, H, W):
            keep = (w * a) != 0 if need_attn else w != 0
            pix = start + yy[keep].long() * W + xx[keep].long()
            touched.append((bn[keep] * S + pix) * heads + h.expand_as(keep)[keep])
            nnz += int(keep.sum())
        start += H * W
    return torch.unique(torch.cat(touched)).numel(), nnz


def msda_bound_ms(value, loc, attn, index, levels):
    """Least ms for one K1 forward call: the value rows its nonzero corner
    weights touch, the selected queries' loc and attn, the index and the
    output over HBM bandwidth; or 2 hd FLOPs a corner over the fp32 rate."""
    BN, S, heads, hd = value.shape
    rows_read, nnz = touched_value_rows(value, loc, attn, index, True, levels)
    R = loc.shape[1] if index is None else index.shape[1]
    per_query = attn[0, 0].numel()
    elt = value.element_size()
    bytes_ = (rows_read * hd * elt + BN * R * per_query * (2 * 4 + 4)
              + (0 if index is None else index.numel() * 8)
              + BN * R * heads * hd * elt)
    t_bytes, t_ops = bytes_ / PEAK_BYTES_PER_S, 2 * hd * nnz / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops)


def dcn_peak_flops(x):
    return PEAK_BF16_TENSOR_FLOPS if x.dtype == torch.bfloat16 else PEAK_FP32_FLOPS


def dcn_bound_ms(x, offsets, w):
    """Least ms for one K2 forward call: x, offsets, mask and the (9 Cin,
    Cout) weight read once and the output written once, or 2 M 9Cin Cout
    FLOPs over the tensor-core rate of x's dtype."""
    B, H, W, C = x.shape
    npix = B * offsets.shape[1] * offsets.shape[2]
    cout = w.shape[1]
    bytes_ = (x.numel() + npix * 27 + w.numel() + npix * cout) * x.element_size()
    t_bytes = bytes_ / PEAK_BYTES_PER_S
    t_ops = 2 * npix * 9 * C * cout / dcn_peak_flops(x)
    return 1e3 * max(t_bytes, t_ops)
