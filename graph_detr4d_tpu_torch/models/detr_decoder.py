"""The generic 2D deformable-DETR decoder, Deformable3DDetrTransformerDecoder
(counterpart of graph_detr4d_tpu/models/detr_decoder.py; reference:
projects/mmdet3d_plugin/models/utils/detr.py:33-115). No registered config
wires it: it is an API-surface module, as in the JAX package.

  * reference points are sigmoid-space (B, Q, 2) or (B, Q, 4); each layer
    scales them by valid_ratios (B, L, 2) into every level's sampling
    space (:78-84);
  * each layer: self-attention, norm, the image-plane multi-scale
    deformable cross-attention (models/dgcnn.py::BEVDeformableCrossAttn:
    offsets normalised by each level's (W, H), softmax over levels x
    points, one K1 call over all queries), norm, FFN, norm;
  * after each layer an external reg branch refines the reference points
    in inverse-sigmoid space, detached; 2-d points refine by the first
    two of its outputs only (:91-104);
  * return_intermediate stacks every layer's output and reference points
    (:107-113).

The module names follow mmcv's decoder layer (`layers.{l}.attentions.{0,1}`,
`ffns.0`, `norms.{0,1,2}`); weights.py::detr_decoder_state_dict_from_jax
maps the JAX module's tree onto them.
"""

from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn

from ..utils.math import inverse_sigmoid
from .dgcnn import BEVDeformableCrossAttn
from .k1_graph import K1Module
from .layers import LayerNorm
from .transformer import FFN, SelfAttention


class DeformableDecoderLayer(K1Module):
    """Post-norm layer: self-attention, norm, deformable cross-attention,
    norm, FFN, norm, with dropout where flax has it; a `steps` generator
    of its cross-attention's K1 call (models/k1_graph.py)."""

    def __init__(self, embed_dims: int, num_heads: int, num_levels: int,
                 num_points: int, ffn_dims: int, dropout: float = 0.1):
        super().__init__()
        self.attentions = nn.ModuleList([
            SelfAttention(embed_dims, num_heads, dropout),
            BEVDeformableCrossAttn(embed_dims, num_heads, num_levels,
                                   num_points, dropout)])
        self.ffns = nn.ModuleList([FFN(embed_dims, ffn_dims, dropout)])
        self.norms = nn.ModuleList([LayerNorm(embed_dims) for _ in range(3)])

    def steps(self, query, query_pos, value_levels, reference_points,
              generator=None):
        """reference_points (B, Q, L, 2) in each level's [0, 1]."""
        query = self.norms[0](self.attentions[0](query, query_pos, generator))
        query = yield from self.attentions[1].steps(
            query, value_levels, reference_points, query_pos, generator)
        query = self.norms[1](query)
        return self.norms[2](self.ffns[0](query, generator))


class Deformable3DDetrTransformerDecoder(nn.Module):
    """The decoder loop with the reference's refinement semantics
    (detr.py:46-115)."""

    def __init__(self, embed_dims: int = 256, num_layers: int = 6,
                 num_heads: int = 8, num_levels: int = 4, num_points: int = 4,
                 ffn_dims: int = 512, dropout: float = 0.1,
                 return_intermediate: bool = True):
        super().__init__()
        self.num_levels = num_levels
        self.return_intermediate = return_intermediate
        self.layers = nn.ModuleList(
            DeformableDecoderLayer(embed_dims, num_heads, num_levels,
                                   num_points, ffn_dims, dropout)
            for _ in range(num_layers))

    def forward(self, query: torch.Tensor, query_pos: torch.Tensor,
                value_levels: Sequence[torch.Tensor],
                reference_points: torch.Tensor,
                valid_ratios: Optional[torch.Tensor] = None,
                reg_branches: Optional[Sequence[Callable]] = None,
                generator=None):
        """query, query_pos (B, Q, C); value_levels L x (B, H_l, W_l, C);
        reference_points (B, Q, 2 or 4) sigmoid-space; valid_ratios (B, L,
        2) (ones when None); reg_branches: one callable a layer, or None;
        generator: dropout's random source in training. Returns the stacked
        outputs (layers, B, Q, C) and reference points (layers, B, Q, 2 or
        4) with return_intermediate, else the last of each."""
        B = query.shape[0]
        if valid_ratios is None:
            valid_ratios = torch.ones(B, self.num_levels, 2,
                                      device=query.device)
        outputs, refs = [], []
        output = query
        for lid, layer in enumerate(self.layers):
            dim = reference_points.shape[-1]
            ratios = (valid_ratios if dim == 2
                      else torch.cat([valid_ratios, valid_ratios], -1))
            ref_input = reference_points[:, :, None, :] * ratios[:, None]
            output = layer(output, query_pos, value_levels,
                           ref_input[..., :2], generator)
            if reg_branches is not None:
                # 2-d points: only the first two outputs refine (:99-104)
                tmp = reg_branches[lid](output)
                reference_points = torch.sigmoid(
                    tmp[..., :dim] + inverse_sigmoid(reference_points)
                ).detach()
            if self.return_intermediate:
                outputs.append(output)
                refs.append(reference_points)
        if self.return_intermediate:
            return torch.stack(outputs), torch.stack(refs)
        return output, reference_points
