"""The generic deformable decoder (models/detr_decoder.py) against
graph_detr4d_tpu/models/detr_decoder.py, fp32 on the CPU (K1 through its
plain version).

The cases of tests/test_variants.py::test_deformable_detr_decoder_generic
(2 layers, 2 levels of 16x32 and 8x16, 2-d and 4-d reference points
refined by external Dense(10) reg branches) with valid_ratios, a case
without reg branches, and the one-layer decoder of
test_msda_impl_reaches_every_call_site. Weights: flax's init with its
zero-initialised projections replaced by seeded noise
(tests/test_torch_modules.py::perturb_variables), carried over by
weights.detr_decoder_state_dict_from_jax. Outputs and reference points
within 2e-4, the raw-head-output tolerance.
"""

import os
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_modules import jax_vars, perturb_variables  # noqa: E402

from graph_detr4d_tpu.models import detr_decoder as jax_dec  # noqa: E402
from graph_detr4d_tpu_torch import weights  # noqa: E402
from graph_detr4d_tpu_torch.models import detr_decoder  # noqa: E402
from graph_detr4d_tpu_torch.models.layers import Linear  # noqa: E402

ATOL = 2e-4

CASES = {  # ref dim, reg branches, valid_ratios, layers, levels (H, W), Q
    "ref2d": (2, True, True, 2, ((16, 32), (8, 16)), 5),
    "ref4d": (4, True, True, 2, ((16, 32), (8, 16)), 5),
    "no_reg_branches": (2, False, False, 2, ((16, 32), (8, 16)), 5),
    "one_layer": (2, False, False, 1, ((4, 8), (2, 4)), 6),
}


class Wrapped(nn.Module):
    """The JAX decoder with external reg branches, as test_variants
    builds it."""

    dec: nn.Module
    regs: bool

    @nn.compact
    def __call__(self, q, qp, feats, ref, valid_ratios):
        branches = ([nn.Dense(10, name=f"reg{i}")
                     for i in range(self.dec.num_layers)] if self.regs else None)
        return self.dec(q, qp, feats, ref, valid_ratios=valid_ratios,
                        reg_branches=branches)


@pytest.mark.parametrize("case", list(CASES))
def test_generic_decoder_matches_jax(case):
    dim, regs, ratios, layers, levels, Q = CASES[case]
    rng = np.random.RandomState(0)
    B, C = 2, 32
    q, qp = (rng.randn(B, Q, C).astype(np.float32) for _ in range(2))
    feats = [rng.randn(B, h, w, C).astype(np.float32) for h, w in levels]
    ref = rng.rand(B, Q, dim).astype(np.float32)
    vr = (rng.uniform(0.5, 1.0, (B, len(levels), 2)).astype(np.float32)
          if ratios else None)
    dec = jax_dec.Deformable3DDetrTransformerDecoder(
        embed_dims=C, num_layers=layers, num_heads=4, num_levels=len(levels),
        num_points=2, ffn_dims=64, name="dec")
    m = Wrapped(dec=dec, regs=regs)
    args = (jnp.asarray(q), jnp.asarray(qp), [jnp.asarray(f) for f in feats],
            jnp.asarray(ref), None if vr is None else jnp.asarray(vr))
    v = perturb_variables(m.init(jax.random.PRNGKey(0), *args))
    want_out, want_ref = m.apply(jax_vars(v), *args)

    port = detr_decoder.Deformable3DDetrTransformerDecoder(
        embed_dims=C, num_layers=layers, num_heads=4, num_levels=len(levels),
        num_points=2, ffn_dims=64)
    port.load_state_dict(weights.detr_decoder_state_dict_from_jax(
        v["params"]["dec"]), strict=True)
    port.eval()
    branches = None
    if regs:
        branches = []
        for i in range(layers):
            lin = Linear(C, 10)
            lin.load_state_dict(weights.to_torch({
                "weight": np.asarray(v["params"][f"reg{i}"]["kernel"]).T,
                "bias": v["params"][f"reg{i}"]["bias"]}))
            branches.append(lin)
    t = torch.from_numpy
    with torch.no_grad():
        got_out, got_ref = port(t(q), t(qp), [t(f) for f in feats], t(ref),
                                valid_ratios=None if vr is None else t(vr),
                                reg_branches=branches)
    assert got_out.shape == (layers, B, Q, C)
    assert got_ref.shape == (layers, B, Q, dim)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got_ref.numpy(), np.asarray(want_ref), rtol=0,
                               atol=ATOL)
    if regs:  # the points moved, and stay in sigmoid space
        assert not np.allclose(got_ref[-1].numpy(), ref)
        assert 0.0 < float(got_ref.min()) and float(got_ref.max()) < 1.0
