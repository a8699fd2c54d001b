"""Plain PyTorch building blocks of the benchmark's references.

Every function here computes in float32 on channels-last tensors and
reads its parameters by their reference (mmdet3d) names from a flat
state dict. Nothing here imports the measured package: the layers are
written again from the published model's description, and where the
program computes the same function another way (cuDNN convolutions, the
CUDA kernels, the per-camera compaction), this file takes the plain route:

  * a k x k convolution is a sum over its k * k taps of matrix products
    of shifted views, so no library algorithm choice (cuDNN's FFT engine
    among them) enters the reference;
  * bilinear sampling gathers its four corners explicitly, with zero
    outside the image (no `grid_sample`);
  * matrix products run without TF32 (`strict_float32`).

`Ref(sd, precision)` carries the weights and the precision of every
matrix product: "fp32" is the reference; "fp8" rounds both operands of
each product to float8 e4m3 at a per-tensor scale, the step below the
configurations' bfloat16 that serves as the comparison's control.
"""

import math

import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "fp8")
FP8_MAX = 448.0  # the largest finite float8 e4m3fn


def strict_float32():
    """Turn TF32 off for matrix products and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def quantizer(precision: str):
    if precision == "fp32":
        return lambda t: t
    if precision == "fp8":
        def q(t):
            scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
            return (t / scale).to(torch.float8_e4m3fn).float() * scale
        return q
    raise ValueError(f"precision {precision!r} not in {PRECISIONS}")


class Ref:
    """Weights by reference name and the precision of the products."""

    def __init__(self, sd: dict, precision: str = "fp32"):
        self.sd = sd
        self.q = quantizer(precision)

    def p(self, name: str) -> torch.Tensor:
        return self.sd[name].float()

    def linear(self, x, prefix: str, bias: bool = True):
        w = self.p(prefix + ".weight")
        w = w.reshape(w.shape[0], -1)  # a 1x1 conv's (O, I, 1, 1) too
        y = torch.matmul(self.q(x), self.q(w).t())
        return y + self.p(prefix + ".bias") if bias else y

    def conv(self, x, prefix: str, stride: int = 1, padding: int = 0,
             bias: bool = False):
        """x (B, H, W, Cin) -> (B, Ho, Wo, Cout) with the (Cout, Cin, kh,
        kw) weight `prefix.weight`: the sum over taps of shifted views
        times the tap's (Cin, Cout) matrix."""
        w = self.q(self.p(prefix + ".weight"))
        x = self.q(x)
        Cout, Cin, kh, kw = w.shape
        B, H, W, _ = x.shape
        Ho = (H + 2 * padding - kh) // stride + 1
        Wo = (W + 2 * padding - kw) // stride + 1
        if padding:
            x = F.pad(x, (0, 0, padding, padding, padding, padding))
        out = torch.zeros(B * Ho * Wo, Cout, device=x.device)
        for ky in range(kh):
            for kx in range(kw):
                tap = x[:, ky:ky + stride * (Ho - 1) + 1:stride,
                        kx:kx + stride * (Wo - 1) + 1:stride]
                out = torch.addmm(out, tap.reshape(-1, Cin), w[:, :, ky, kx].t())
        out = out.view(B, Ho, Wo, Cout)
        return out + self.p(prefix + ".bias") if bias else out

    def frozen_bn(self, x, prefix: str, eps: float = 1e-5):
        scale = self.p(prefix + ".weight") / torch.sqrt(
            self.p(prefix + ".running_var") + eps)
        return x * scale + (self.p(prefix + ".bias")
                            - self.p(prefix + ".running_mean") * scale)

    def layer_norm(self, x, prefix: str, eps: float = 1e-5):
        return F.layer_norm(x, x.shape[-1:], self.p(prefix + ".weight"),
                            self.p(prefix + ".bias"), eps)

    def mlp2(self, x, prefix: str):
        """1x1 conv, relu, 1x1 conv (state-dict indices 0 and 2)."""
        return self.linear(torch.relu(self.linear(x, prefix + ".0")),
                           prefix + ".2")

    def se(self, x, x_se, prefix: str):
        """x * sigmoid(expand(relu(reduce(x_se))))."""
        s = self.linear(torch.relu(self.linear(x_se, prefix + ".conv_reduce")),
                        prefix + ".conv_expand")
        return x * torch.sigmoid(s)

    def mha(self, query, key, value, prefix: str, num_heads: int):
        """Multi-head attention with a packed in-projection
        (`in_proj_weight` (3C, C)), softmax over the keys, `out_proj`."""
        B, Q, C = query.shape
        hd = C // num_heads
        w, b = self.p(prefix + ".in_proj_weight"), self.p(prefix + ".in_proj_bias")

        def heads(x, i):
            y = torch.matmul(self.q(x), self.q(w[i * C:(i + 1) * C]).t())
            y = y + b[i * C:(i + 1) * C]
            return y.view(B, -1, num_heads, hd).transpose(1, 2)

        q = heads(query, 0) / math.sqrt(hd)
        k, v = heads(key, 1), heads(value, 2)
        logits = torch.matmul(self.q(q), self.q(k).transpose(-1, -2))
        weights = torch.softmax(logits, dim=-1)
        out = torch.matmul(self.q(weights), self.q(v))
        return self.linear(out.transpose(1, 2).reshape(B, Q, C),
                           prefix + ".out_proj")

    def ffn(self, x, prefix: str):
        """x + Linear(relu(Linear(x))) (`layers.0.0`, `layers.1`)."""
        y = torch.relu(self.linear(x, prefix + ".layers.0.0"))
        return x + self.linear(y, prefix + ".layers.1")


def bilinear(x, py, px):
    """Sample x (B, H, W, C) at pixel coordinates (py, px) (B, ...):
    bilinear between the four integer corners, each corner outside the
    image reading zero. Returns (B, ..., C)."""
    B, H, W, C = x.shape
    shape = py.shape
    flat = x.reshape(B, H * W, C)
    y0, x0 = torch.floor(py), torch.floor(px)
    fy, fx = py - y0, px - x0
    out = torch.zeros(*shape, C, device=x.device)
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            yy, xx = y0 + dy, x0 + dx
            inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).long()
            g = torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(-1, -1, C))
            out += g.view(*shape, C) * (wy * wx * inside)[..., None]
    return out


def inverse_sigmoid(x, eps: float = 1e-5):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def sine_pe_3d(B, N, H, W, num_feats, offset, device, temperature=10000.0,
               eps=1e-6):
    """The 3-axis sine position encoding of an unpadded (B, N, H, W)
    grid, normalised, block layout [sin(p0), sin(p2), ..., cos(p1),
    cos(p3), ...] per axis, axes (camera, y, x): (B, N, H, W, 3 F)."""
    scale = 2 * math.pi

    def axis(n):
        e = torch.arange(1, n + 1, dtype=torch.float32, device=device)
        return (e + offset) / (n + eps) * scale

    dim_t = torch.arange(num_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * (dim_t // 2) / num_feats)

    def encode(e):
        p = e[..., None] / dim_t
        return torch.cat([p[..., 0::2].sin(), p[..., 1::2].cos()], dim=-1)

    n, y, x = axis(N), axis(H), axis(W)
    shape = (B, N, H, W, num_feats)
    return torch.cat([
        encode(n)[None, :, None, None, :].expand(shape),
        encode(y)[None, None, :, None, :].expand(shape),
        encode(x)[None, None, None, :, :].expand(shape)], dim=-1)


def lid_bins(depth_num, start, stop, device):
    """Linear-increasing depth bins start + b i (i + 1), b = (stop -
    start) / (D (D + 1))."""
    i = torch.arange(depth_num, dtype=torch.float32, device=device)
    return start + (stop - start) / (depth_num * (1 + depth_num)) * i * (i + 1)


def coords_3d(lidar2img, H, W, img_shape, depth, position_range):
    """Per-pixel 3D points of a (H, W) feature grid: pixel (x, y) at (x
    pad_w / W, y pad_h / H) of the network input, each depth bin
    back-projected through the inverse of lidar2img (inverted in float64),
    normalised to position_range and inverse-sigmoided: (B, N, H, W, D
    * 3), channels (d, xyz)."""
    B, N = lidar2img.shape[:2]
    dev = lidar2img.device
    pad_h, pad_w = img_shape
    ys = torch.arange(H, dtype=torch.float32, device=dev) * pad_h / H
    xs = torch.arange(W, dtype=torch.float32, device=dev) * pad_w / W
    d = depth.clamp(min=1e-5)
    D = d.shape[0]
    pix = torch.stack([
        (xs[None, :, None] * d).expand(H, W, D),
        (ys[:, None, None] * d).expand(H, W, D),
        d.expand(H, W, D),
        torch.ones(H, W, D, device=dev)], dim=-1)
    img2lidar = torch.linalg.inv(lidar2img.double()).float()
    pts = torch.einsum("bnij,hwdj->bnhwdi", img2lidar, pix)[..., :3]
    lo = torch.tensor(position_range[:3], device=dev)
    hi = torch.tensor(position_range[3:], device=dev)
    return inverse_sigmoid((pts - lo) / (hi - lo)).reshape(B, N, H, W, D * 3)


def decode_boxes(codes):
    """Codes (..., 10) -> boxes (..., 9): centre, exp sizes, yaw from
    (sin, cos), velocity."""
    return torch.cat([
        codes[..., 0:2], codes[..., 4:5], codes[..., 2:4].exp(),
        codes[..., 5:6].exp(),
        torch.atan2(codes[..., 6:7], codes[..., 7:8]), codes[..., 8:10]],
        dim=-1)


def nms_free_decode(cls_logits, codes, max_num, post_center_range):
    """The NMS-free answer of one frame's last decoder layer: sigmoid
    scores, the top max_num over (query, class) by a stable descending
    sort, their boxes, and whether each centre lies in
    post_center_range. cls_logits (Q, classes), codes (Q, 10)."""
    classes = cls_logits.shape[-1]
    scores = torch.sigmoid(cls_logits.float()).flatten()
    top, idx = torch.sort(scores, descending=True, stable=True)
    top, idx = top[:max_num], idx[:max_num]
    boxes = decode_boxes(codes.float()[idx // classes])
    pcr = torch.tensor(post_center_range, device=boxes.device)
    valid = ((boxes[:, :3] >= pcr[:3]).all(-1)
             & (boxes[:, :3] <= pcr[3:]).all(-1))
    return {"bboxes": boxes, "scores": top,
            "labels": (idx % classes).to(torch.int32), "valid": valid}
