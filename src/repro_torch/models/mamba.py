"""Mamba (selective SSM) block (port of repro/models/mamba.py: `_dims` :16,
`init_mamba` :23, `_ssm_inputs` :43, `mamba_forward` :76,
`mamba_init_state` :138, `mamba_decode` :146).

The full-sequence forward walks time chunks carrying the SSM state, and
evaluates h_t = Abar_t h_{t-1} + Bx_t inside a chunk with the same
odd/even associative scan as `jax.lax.associative_scan` (`_assoc_scan`),
combining each chunk as h = b_cum + a_cum * h0. The dtype trail is the
reference's: projections and the causal conv in the parameter dtype,
dt / abar / bx / h in fp32, A_log and D fp32 under bf16 params.
No Pallas kernel reaches this module in the reference, so it stays plain
PyTorch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, dense_init, torch_dtype


def _dims(cfg):
    mc = cfg.mamba
    d_inner = int(mc.expand * cfg.d_model)
    dt_rank = mc.dt_rank or -(-cfg.d_model // 16)
    return mc, d_inner, dt_rank


def init_mamba(gen: torch.Generator, cfg, lead=()) -> Params:
    mc, di, dtr = _dims(cfg)
    d = cfg.d_model
    dt = torch_dtype(cfg.param_dtype)
    dev = gen.device
    a = torch.arange(1, mc.d_state + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": dense_init(gen, (d, 2 * di), dt, lead=lead),
        "conv_w": dense_init(gen, (mc.d_conv, di), dt, scale=0.5, lead=lead),
        "conv_b": torch.zeros((*lead, di), dtype=dt, device=dev),
        "x_proj": dense_init(gen, (di, dtr + 2 * mc.d_state), dt, lead=lead),
        "dt_proj": dense_init(gen, (dtr, di), dt, lead=lead),
        "dt_bias": torch.full((*lead, di), -4.6, dtype=dt, device=dev),  # softplus^-1(0.01)
        "A_log": torch.log(a).expand(*lead, di, mc.d_state).clone(),
        "D": torch.ones((*lead, di), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (di, d), dt, lead=lead),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus as JAX writes it: logaddexp(x, 0)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_inputs(p: Params, cfg, xz: torch.Tensor, conv_state=None):
    """Shared pre-scan computation. xz: [B, S, D]. The trailing `xc` is
    the conv input with its causal pad prepended: masked prefill gathers
    per-row conv states out of it."""
    mc, di, dtr = _dims(cfg)
    xi = torch.einsum("bsd,de->bse", xz, p["in_proj"])
    x, z = xi.chunk(2, dim=-1)  # [B, S, Di] each
    # causal depthwise conv over time, tap by tap in the parameter dtype
    pad = (torch.zeros((x.shape[0], mc.d_conv - 1, di), dtype=x.dtype, device=x.device)
           if conv_state is None else conv_state)
    xc = torch.cat([pad, x], dim=1)
    new_conv_state = xc[:, -(mc.d_conv - 1):, :] if mc.d_conv > 1 else pad
    s = x.shape[1]
    x = sum(xc[:, i:i + s, :] * p["conv_w"][i] for i in range(mc.d_conv)) + p["conv_b"]
    x = F.silu(x.float()).to(xz.dtype)

    proj = torch.einsum("bsi,ie->bse", x, p["x_proj"])
    dt_in, b_ssm, c_ssm = torch.split(proj, [dtr, mc.d_state, mc.d_state], dim=-1)
    dt = _softplus(torch.einsum("bsr,ri->bsi", dt_in, p["dt_proj"]).float()
                   + p["dt_bias"].float())  # [B, S, Di] fp32
    a = -torch.exp(p["A_log"])  # [Di, N] fp32
    abar = torch.exp(dt[..., None] * a)  # [B, S, Di, N]
    bx = (dt * x.float())[..., None] * b_ssm.float()[:, :, None, :]  # [B, S, Di, N]
    return x, z, abar, bx, c_ssm, new_conv_state, xc


def _assoc_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along dim 1 of the affine maps h -> a h + b, combined
    (al, bl) . (ar, br) = (al ar, ar bl + br): the odd/even recursion of
    `jax.lax.associative_scan`, so every element takes the reference's
    operations in the reference's order. Returns (a_cum, b_cum)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ae, be, ao, bo = a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]
    oa, ob = _assoc_scan(ae * ao, ao * be + bo)
    a2, b2 = a[:, 2::2], b[:, 2::2]
    if n % 2 == 0:
        oa_, ob_ = oa[:, :-1], ob[:, :-1]
    else:
        oa_, ob_ = oa, ob
    ea = torch.cat([a[:, :1], oa_ * a2], dim=1)
    eb = torch.cat([b[:, :1], a2 * ob_ + b2], dim=1)
    a_cum, b_cum = torch.empty_like(a), torch.empty_like(b)
    a_cum[:, 0::2], a_cum[:, 1::2] = ea, oa
    b_cum[:, 0::2], b_cum[:, 1::2] = eb, ob
    return a_cum, b_cum


def mamba_forward(p: Params, cfg, xz: torch.Tensor, chunk: int = 128,
                  return_state: bool = False, token_mask: torch.Tensor | None = None):
    """Full-sequence forward from the zero state. xz: [B, S, D] -> [B, S, D].

    `token_mask` [B, S] bool marks real tokens (right padding): pad steps
    carry the SSM state unchanged (abar = 1, bx = 0), and the returned
    conv state is the window ending at each row's last real token, so
    the final {ssm, conv} equals an unpadded forward of the same row.
    Outputs at pad positions are unspecified."""
    mc, di, _ = _dims(cfg)
    b, s, _ = xz.shape
    x, z, abar, bx, c_ssm, new_conv, xc = _ssm_inputs(p, cfg, xz)
    if token_mask is not None:
        live = token_mask[..., None, None]  # [B, S, 1, 1]
        abar = torch.where(live, abar, torch.ones_like(abar))  # identity on pads
        bx = torch.where(live, bx, torch.zeros_like(bx))

    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    h0 = torch.zeros((b, di, mc.d_state), dtype=torch.float32, device=xz.device)
    hs = []
    for c0 in range(0, s, chunk):
        a_cum, b_cum = _assoc_scan(abar[:, c0:c0 + chunk], bx[:, c0:c0 + chunk])
        h = b_cum + a_cum * h0[:, None]  # [B, c, Di, N]
        h0 = h[:, -1]
        hs.append(h)
    h = torch.cat(hs, dim=1) if len(hs) > 1 else hs[0]

    y = torch.einsum("bsin,bsn->bsi", h, c_ssm.float())
    y = y + p["D"] * x.float()
    y = y.to(xz.dtype) * F.silu(z.float()).to(xz.dtype)
    out = torch.einsum("bsi,id->bsd", y, p["out_proj"])
    if not return_state:
        return out
    if token_mask is not None and mc.d_conv > 1:
        # input position t sits at xc index t + d_conv - 1, so the window
        # of positions [L - d_conv + 1, L - 1] is xc[L : L + d_conv - 1]
        # (short rows reach into the zero pad, as unpadded ones do)
        lengths = token_mask.sum(-1)
        gidx = lengths[:, None] + torch.arange(mc.d_conv - 1, device=xz.device)[None, :]
        new_conv = torch.take_along_dim(xc, gidx[..., None], dim=1)
    return out, {"ssm": h0, "conv": new_conv}


def mamba_init_state(cfg, batch: int, dtype, device=None):
    mc, di, _ = _dims(cfg)
    return {
        "ssm": torch.zeros((batch, di, mc.d_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, mc.d_conv - 1, di), dtype=dtype, device=device),
    }


def mamba_decode(p: Params, cfg, xz: torch.Tensor, state):
    """Single-token step. xz: [B, 1, D]; state: {ssm, conv}."""
    x, z, abar, bx, c_ssm, new_conv, _ = _ssm_inputs(p, cfg, xz, state["conv"])
    h = abar[:, 0] * state["ssm"] + bx[:, 0]  # [B, Di, N]
    y = torch.einsum("bin,bn->bi", h, c_ssm[:, 0].float())
    y = y + p["D"] * x[:, 0].float()
    y = y.to(xz.dtype) * F.silu(z[:, 0].float()).to(xz.dtype)
    out = torch.einsum("bi,id->bd", y, p["out_proj"])[:, None, :]
    return out, {"ssm": h, "conv": new_conv}
