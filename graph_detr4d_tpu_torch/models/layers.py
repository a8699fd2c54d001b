"""Building blocks (counterpart of graph_detr4d_tpu/models/layers.py).

Parameters are float32, as the JAX package keeps them. The compute layers
here cast their parameters to the dtype of their input on each call, as a
flax module with `dtype=bfloat16` does, so one model runs fp32 or bf16 by
the dtype it is fed: bf16 on the conv and matmul paths, fp32 where the
caller keeps fp32 (projection and PE math, softmax, gate, coder).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


def dropout(x, p: float, generator, shape=None):
    """flax `nn.Dropout` in training: keep each element with probability
    1 - p and scale it by 1 / (1 - p); the mask is drawn from `generator`
    at `shape` (default x's shape; smaller shapes broadcast). The identity
    for generator None (eval) or p == 0."""
    if generator is None or p == 0.0:
        return x
    keep = torch.rand(x.shape if shape is None else shape,
                      generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0)


class Linear(nn.Linear):
    """nn.Linear computing in its input's dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class Conv2d(nn.Conv2d):
    """nn.Conv2d (NCHW, any memory format) computing in its input's dtype."""

    def forward(self, x):
        return self._conv_forward(
            x, self.weight.to(x.dtype), _cast(self.bias, x.dtype)
        )


class PointwiseConv(nn.Conv2d):
    """A 1x1 conv (the reference's layout, weight (O, I, 1, 1)) applied to a
    channels-last tensor (..., I) as the linear map it is."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 1)

    def forward(self, x):
        return F.linear(
            x, self.weight.flatten(1).to(x.dtype), _cast(self.bias, x.dtype)
        )


class LayerNorm(nn.LayerNorm):
    """LayerNorm with statistics in fp32, output in the input's dtype."""

    def forward(self, x):
        y = F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        )
        return y.to(x.dtype)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics: a per-channel affine (NCHW, or
    channels last with `channels_last`).

    The reference trains every backbone BN in eval mode with
    requires_grad=False (configs/...12e.py:37-38). The statistics are
    buffers under mmcv's names, so the reference's state_dict loads.
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 channels_last: bool = False):
        super().__init__()
        self.eps = eps
        self.channels_last = channels_last  # channels on the last axis
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # an mmcv BatchNorm checkpoint also carries num_batches_tracked
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x):
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        bias = self.bias - self.running_mean * scale
        shape = (-1,) if self.channels_last else (1, -1, 1, 1)
        return x * scale.to(x.dtype).view(shape) + bias.to(x.dtype).view(shape)


class SELayer(nn.Module):
    """Squeeze-excite gate used as `fpe` in the PE head
    (detr3d_head_pe.py:231-243): x * sigmoid(expand(relu(reduce(x_se)))),
    channels-last."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_reduce = PointwiseConv(channels, channels)
        self.conv_expand = PointwiseConv(channels, channels)

    def forward(self, x, x_se):
        se = self.conv_expand(F.relu(self.conv_reduce(x_se)))
        return x * torch.sigmoid(se)


def two_layer_mlp(in_channels: int, hidden: int, out: int) -> nn.Sequential:
    """1x1 conv -> relu -> 1x1 conv on channels-last input (the head's
    position_encoder / adapt_pos3d, state_dict indices 0 and 2)."""
    return nn.Sequential(
        PointwiseConv(in_channels, hidden),
        nn.ReLU(),
        PointwiseConv(hidden, out),
    )


def ln_mlp(in_features: int, out: int) -> nn.Sequential:
    """(Linear -> LayerNorm -> relu) x2: the cross-attention positional MLP
    (deform3d_cross_attn.py:104-111, state_dict indices 0, 1, 3, 4)."""
    return nn.Sequential(
        Linear(in_features, out),
        LayerNorm(out),
        nn.ReLU(),
        Linear(out, out),
        LayerNorm(out),
        nn.ReLU(),
    )
