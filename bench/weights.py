"""Seeded random weights, layer by layer, drawn on the device.

Every leaf of every layer has a seed of its own, derived from the run's
`--seed`, the layer's index and the leaf's name. So the program's stacked
tree is filled slice by slice in place (`fill`), and the reference draws
any one layer again after the program is gone (`layer_leaves`), bit for
bit: the same generator, device, shape and dtype give the same values.

The scales keep activations of order one through any depth: each
projection's entries are N(0, 1 / fan_in), fan_in the product of the
dimensions it contracts; the embedding N(0, 1); norm scales, the Mamba
conv bias, dt bias and skip D are drawn around their usual values, so the
reference has to apply them. Imports nothing of the program.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import torch

from spec import Dims, family

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# leaf -> (shape, dtype key, init); init: ("normal", scale) or ("around", mean, std)
# or ("a_log",); dtype key "param" is the served dtype, "f32" always float32
Leaf = Tuple[Tuple[int, ...], str, tuple]


def leaf_seed(seed: int, layer, name: str) -> int:
    h = hashlib.sha256(f"{seed}/{layer}/{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") & (2**63 - 1)


def _proj(shape, fan_in) -> Leaf:
    return (tuple(shape), "param", ("normal", fan_in ** -0.5))


def mla_leaves(dims: Dims) -> Dict[str, Leaf]:
    d, h, r, rd = dims.d_model, dims.n_heads, dims.kv_lora_rank, dims.qk_rope_head_dim
    nope, v = dims.qk_nope_head_dim, dims.v_head_dim
    return {
        "mixer.wq": _proj((d, h, nope + rd), d),
        "mixer.wkv_a": _proj((d, r + rd), d),
        "mixer.wkv_b": _proj((r, h, nope + v), r),
        "mixer.wo": _proj((h, v, d), h * v),
    }


def gqa_leaves(dims: Dims) -> Dict[str, Leaf]:
    d, h, kv, hd = dims.d_model, dims.n_heads, dims.n_kv_heads, dims.head_dim
    return {
        "mixer.wq": _proj((d, h, hd), d),
        "mixer.wk": _proj((d, kv, hd), d),
        "mixer.wv": _proj((d, kv, hd), d),
        "mixer.wo": _proj((h, hd, d), h * hd),
    }


def mamba_leaves(dims: Dims) -> Dict[str, Leaf]:
    d, di, n, dtr, k = dims.d_model, dims.d_inner, dims.d_state, dims.dt_rank, dims.d_conv
    return {
        "mixer.in_proj": _proj((d, 2 * di), d),
        "mixer.conv_w": _proj((k, di), k),
        "mixer.conv_b": ((di,), "param", ("around", 0.0, 0.1)),
        "mixer.x_proj": _proj((di, dtr + 2 * n), di),
        "mixer.dt_proj": _proj((dtr, di), dtr),
        "mixer.dt_bias": ((di,), "param", ("around", -4.6, 0.5)),
        "mixer.A_log": ((di, n), "f32", ("a_log",)),
        "mixer.D": ((di,), "f32", ("around", 1.0, 0.1)),
        "mixer.out_proj": _proj((di, d), di),
    }


def dense_leaves(dims: Dims) -> Dict[str, Leaf]:
    d, f = dims.d_model, dims.d_ff
    return {"ffn.w_gate": _proj((d, f), d), "ffn.w_up": _proj((d, f), d),
            "ffn.w_down": _proj((f, d), f)}


def moe_leaves(dims: Dims) -> Dict[str, Leaf]:
    d, e, f = dims.d_model, dims.n_experts, dims.d_expert
    out = {
        "ffn.router": ((d, e), "f32", ("normal", d ** -0.5)),
        "ffn.w_gate": _proj((e, d, f), d),
        "ffn.w_up": _proj((e, d, f), d),
        "ffn.w_down": _proj((e, f, d), f),
    }
    if dims.n_shared:
        s = dims.n_shared
        out.update({
            "ffn.shared.w_gate": _proj((s, d, f), d),
            "ffn.shared.w_up": _proj((s, d, f), d),
            "ffn.shared.w_down": _proj((s, f, d), f),
        })
    return out


MIXER_LEAVES = {"mla": mla_leaves, "attn": gqa_leaves, "mamba": mamba_leaves}
FFN_LEAVES = {"dense": dense_leaves, "moe": moe_leaves}


def block_spec(dims: Dims, i: int) -> Dict[str, Leaf]:
    """A pre-norm block's leaves: norm, mixer, norm, FFN, by layer `i`'s
    signature."""
    mixer, ffn = dims.sigs[i]
    d = dims.d_model
    return {"norm1.scale": ((d,), "param", ("around", 1.0, 0.1)), **MIXER_LEAVES[mixer](dims),
            "norm2.scale": ((d,), "param", ("around", 1.0, 0.1)), **FFN_LEAVES[ffn](dims)}


def layer_spec(dims: Dims, i: int) -> Dict[str, Leaf]:
    """Leaves of layer `i`, keyed by their path in the program's tree
    ("mixer.wq", "ffn.shared.w_up", ...), per layer (no stacking dim):
    the family's `layer_spec`, or `block_spec`."""
    return getattr(family(dims.model_type), "layer_spec", block_spec)(dims, i)


def global_spec(dims: Dims) -> Dict[str, Leaf]:
    d, v = dims.d_model, dims.vocab
    return {
        "embed.table": ((v, d), "param", ("normal", 1.0)),
        "final_norm.scale": ((d,), "param", ("around", 1.0, 0.1)),
        "head.w": _proj((d, v), d),
    }


def dtype_of(dims: Dims, key: str) -> torch.dtype:
    return torch.float32 if key == "f32" else DTYPES[dims.dtype]


def fill(out: torch.Tensor, seed: int, layer, name: str, init: tuple) -> torch.Tensor:
    """Draw leaf `name` of `layer` into `out` (contiguous, on its device),
    in place, in the dtype `out` has."""
    if init[0] == "a_log":  # Mamba's S4D-real init, the same in every layer
        n = out.shape[-1]
        a = torch.arange(1, n + 1, dtype=torch.float32, device=out.device)
        return out.copy_(torch.log(a).expand(out.shape))
    gen = torch.Generator(device=out.device).manual_seed(leaf_seed(seed, layer, name))
    out.normal_(generator=gen)
    if init[0] == "normal":
        return out.mul_(init[1])
    return out.mul_(init[2]).add_(init[1])


def draw(dims: Dims, seed: int, layer, name: str, leaf: Leaf, device) -> torch.Tensor:
    shape, key, init = leaf
    out = torch.empty(shape, dtype=dtype_of(dims, key), device=device)
    return fill(out, seed, layer, name, init)


def layer_leaves(dims: Dims, seed: int, i: int, device) -> Dict[str, torch.Tensor]:
    """Layer `i`'s leaves drawn again, each cast to float32 right after its
    draw."""
    return {name: draw(dims, seed, i, name, leaf, device).float()
            for name, leaf in layer_spec(dims, i).items()}


def global_leaves(dims: Dims, seed: int, device) -> Dict[str, torch.Tensor]:
    """The embedding, final norm and head drawn again, in float32."""
    return {name: draw(dims, seed, "global", name, leaf, device).float()
            for name, leaf in global_spec(dims).items()}
