"""The plain reference: the served model's forward pass in float32 over
whole sequences, with no kernel, cache or batching (the layers are in
`layers.py`, composed by the configuration's family). It imports neither
JAX nor anything of the program; its weights are the benchmark's own
(`weights.py`), drawn again layer by layer, so that only one layer's
float32 weights are held at a time beside the sequences' hidden states.
"""
from __future__ import annotations

from typing import List

import torch

from reference.layers import Quant, block, mm, rmsnorm, strict_fp32
from spec import Dims, family
from weights import global_leaves, layer_leaves


@torch.no_grad()
def logits_at(dims: Dims, seed: int, seqs: List[torch.Tensor], at: List[torch.Tensor],
              device, quant: Quant = None) -> List[torch.Tensor]:
    """For each token sequence seqs[j] ([S_j] int64), the logits [len(at[j]),
    V] (float32) at its positions at[j]: the full causal forward over the
    sequence, weights drawn from `seed` one layer at a time."""
    strict_fp32()
    g = global_leaves(dims, seed, device)
    xs = [g["embed.table"][s.to(device)] for s in seqs]
    final, head = g["final_norm.scale"], g["head.w"]
    del g
    layer = getattr(family(dims.model_type), "reference_layer", block)
    for i in range(dims.n_layers):
        w = layer_leaves(dims, seed, i, device)
        xs = [layer(w, x, dims, i, quant) for x in xs]
        del w
    out = []
    for x, pos in zip(xs, at):
        h = rmsnorm(x[pos.to(device)], final, dims.norm_eps)
        out.append(mm(h, head, quant))
    return out

