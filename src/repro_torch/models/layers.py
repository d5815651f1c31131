"""Shared layers: norms, rotary embeddings, SwiGLU, embeddings (port of
repro/models/layers.py).

Params are nested dicts of tensors with the JAX package's tree layout.
Initializers draw from an explicit `torch.Generator` on the target
device; `lead` prepends stacking dims (the scan-group dim of
params["stack"]) without changing the per-layer fan-in.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    """A config dtype string ("bfloat16" | "float32") as a torch dtype."""
    return DTYPES[name]


class _MetaGenerator(torch.Generator):
    """A CPU generator whose draws land on the meta device (which has no
    generator of its own): shapes and dtypes only, nothing allocated."""

    @property
    def device(self):
        return torch.device("meta")


def make_generator(seed: int, device) -> torch.Generator:
    """The seeded generator the initializers draw from on `device`."""
    device = torch.device(device)
    if device.type == "meta":
        return _MetaGenerator().manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
               scale: Optional[float] = None, lead: Sequence[int] = ()):
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    x = torch.randn((*lead, *shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    # scaled in place: one fp32 copy of the draw, not two (a full-width
    # cold tier buffer is ~9 GB in fp32)
    return x.mul_(scale).to(dtype)


# ----------------------------------------------------------------- RMSNorm
def init_rmsnorm(d: int, dtype, device, lead: Sequence[int] = ()) -> Params:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ------------------------------------------------------------------- RoPE
def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's magnitude correction 0.1 * mscale * ln(factor) + 1 (1 for no
    stretch)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def _yarn_dim(rotations: float, dim: int, theta: float, n_pos: int) -> float:
    """The frequency index that turns `rotations` times over `n_pos`."""
    return dim * math.log(n_pos / (rotations * 2 * math.pi)) / (2 * math.log(theta))


def rope_frequencies(head_dim: int, theta: float, device=None, yarn=None) -> torch.Tensor:
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))
    if yarn is None:
        return freqs
    # extrapolated (as trained) below index `low`, interpolated (/ factor)
    # above `high`, a linear ramp between
    n = yarn.original_max_position_embeddings
    low = max(math.floor(_yarn_dim(yarn.beta_fast, head_dim, theta, n)), 0)
    high = min(math.ceil(_yarn_dim(yarn.beta_slow, head_dim, theta, n)), head_dim - 1)
    ramp = ((torch.arange(half, dtype=torch.float32, device=device) - low)
            / (high - low if high > low else 0.001)).clamp(0, 1)
    return freqs / yarn.factor * ramp + freqs * (1 - ramp)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               yarn=None) -> torch.Tensor:
    """x: [..., seq, n_heads, head_dim]; positions: [..., seq]. `yarn`
    (configs.base.YarnScaling) stretches the frequencies and scales cos
    and sin by mscale(factor, mscale) / mscale(factor, mscale_all_dim)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device, yarn)  # [hd/2]
    ang = positions[..., None].float() * freqs  # [..., seq, hd/2]
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    if yarn is not None:
        m = yarn_mscale(yarn.factor, yarn.mscale) / yarn_mscale(yarn.factor, yarn.mscale_all_dim)
        if m != 1.0:
            cos, sin = cos * m, sin * m
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- SwiGLU
def init_mlp(gen, d_model: int, d_ff: int, dtype, lead: Sequence[int] = ()) -> Params:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype, lead=lead),
        "w_up": dense_init(gen, (d_model, d_ff), dtype, lead=lead),
        "w_down": dense_init(gen, (d_ff, d_model), dtype, lead=lead),
    }


def mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ params["w_down"]


# ------------------------------------------------------------- Embeddings
def init_embedding(gen, vocab: int, d_model: int, dtype) -> Params:
    return {"table": dense_init(gen, (vocab, d_model), dtype, scale=1.0)}


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens.long()]


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["table"].T


def init_lm_head(gen, d_model: int, vocab: int, dtype) -> Params:
    return {"w": dense_init(gen, (d_model, vocab), dtype)}


def lm_head(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"]
