"""Seeded weights, made on the device in a few large calls.

The recipe is the one the program's `weights.init_weights` follows
(graph_detr4d_tpu_torch/weights.py:646-751), written out per tensor by
each reference's `param_specs`: lecun-normal weights and zero biases by
default, he-normal DCN weights, xavier-uniform value, output and
reference-point projections, the circular-cone offset bias, the focal
prior on the class bias, N(0, 1) query embeddings, the reg branches'
output layers at a tenth of lecun scale; the projections the published
model zero-initialises (DCN offsets, sampling offsets, attention and
camera gates) get noise, and frozen BN statistics vary, so that every
path carries non-trivial values. All normal tensors come from one
`randn` call and all uniform ones from one `rand` call of a generator on
the device, in float32, the type the program keeps its parameters in.
"""

import torch


def make_state_dict(specs, seed: int, device) -> dict:
    """{name: tensor} for [(name, shape, init)] from `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sizes = {"normal": 0, "uniform": 0}
    for _, shape, init in specs:
        if init[0] in sizes:
            sizes[init[0]] += _numel(shape)
    normal = torch.randn(sizes["normal"], generator=gen, device=device)
    uniform = torch.rand(sizes["uniform"], generator=gen, device=device)
    used = {"normal": 0, "uniform": 0}
    sd = {}
    for name, shape, init in specs:
        kind, n = init[0], _numel(shape)
        if kind == "normal":
            t = normal[used[kind]:used[kind] + n] * init[1]
        elif kind == "uniform":
            lo, hi = init[1], init[2]
            t = uniform[used[kind]:used[kind] + n] * (hi - lo) + lo
        elif kind == "const":
            t = torch.full((n,), float(init[1]), device=device)
        elif kind == "values":
            t = torch.tensor(init[1], dtype=torch.float32, device=device)
        else:
            raise ValueError(f"{name}: unknown init {init}")
        if kind in used:
            used[kind] += n
        sd[name] = t.view(shape)
    return sd


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n
