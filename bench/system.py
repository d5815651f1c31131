"""The system under test, `repro_torch`, as the benchmark drives it: the
port's configuration built from a configuration file, the benchmark's
weights laid out in the tree `ServingLoop` takes, and the loop itself.
With the family modules of `bench/ports/`, the only modules of the
benchmark that import the program.
"""
from __future__ import annotations

from typing import Optional

import torch

from spec import BENCH, Dims, module_at
from weights import draw, dtype_of, fill, global_spec, layer_spec

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import layer_signature, stack_plan
from repro_torch.obs import ObsConfig
from repro_torch.serving.loop import ServingLoop
from repro_torch.serving.tiered_moe import TierSizes

PORTS = BENCH / "ports"


def port_config(dims: Dims) -> ModelConfig:
    """The port's configuration of `dims`, from the family's port module
    `bench/ports/<model_type>.py`; raises where the port cannot run what
    the file states."""
    if not dims.norm_topk_prob:
        raise ValueError("the port renormalizes the top-k routing weights: "
                         "norm_topk_prob must be true")
    common = dict(name=dims.name, n_layers=dims.n_layers, d_model=dims.d_model,
                  n_heads=dims.n_heads, n_kv_heads=dims.n_kv_heads, d_ff=dims.d_ff,
                  vocab_size=dims.vocab, rope_theta=dims.rope_theta, norm_eps=dims.norm_eps,
                  param_dtype=dims.dtype, compute_dtype=dims.dtype)
    cfg = module_at(PORTS / f"{dims.model_type}.py").port_config(dims, common)
    port_sigs = tuple(layer_signature(cfg, i) for i in range(dims.n_layers))
    if port_sigs != dims.sigs:
        raise ValueError(f"the port lays out {port_sigs}, the file states {dims.sigs}")
    return cfg


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, val in flat.items():
        *parents, leaf = path.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return out


def build_params(dims: Dims, cfg: ModelConfig, seed: int, device) -> dict:
    """The benchmark's weights in the port's tree: unrolled layers as
    "layer<i>", periodic ones stacked under "stack"/"slot<j>" with the
    scan-group dim first; each layer's slice drawn in place."""
    unrolled, n_groups, period = stack_plan(cfg)

    def leaf(layers, name, spec):
        shape, key, init = spec
        out = torch.empty((len(layers), *shape), dtype=dtype_of(dims, key), device=device)
        for g, li in enumerate(layers):
            fill(out[g], seed, li, name, init)
        return out

    tree = _nest({name: draw(dims, seed, "global", name, spec, device)
                  for name, spec in global_spec(dims).items()})
    for li in unrolled:
        tree[f"layer{li}"] = _nest({name: draw(dims, seed, li, name, spec, device)
                                    for name, spec in layer_spec(dims, li).items()})
    tree["stack"] = {}
    for j in range(len(period)):
        layers = [len(unrolled) + g * len(period) + j for g in range(n_groups)]
        tree["stack"][f"slot{j}"] = _nest({name: leaf(layers, name, spec)
                                           for name, spec in layer_spec(dims, layers[0]).items()})
    return tree


def build_loop(cfg: ModelConfig, params: dict, loop_args: dict, device, trace: bool
               ) -> ServingLoop:
    """The cell's ServingLoop: its own arguments, the sanitizer off
    whatever the environment says, the tracer on in a traced run."""
    args = dict(loop_args)
    sizes: Optional[list] = args.pop("sizes", None)
    return ServingLoop(cfg, params, sizes=TierSizes(*sizes) if sizes else None,
                       kv_sanitize=False, obs=ObsConfig(trace=trace), device=device, **args)
