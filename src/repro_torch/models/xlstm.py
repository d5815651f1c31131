"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory with
exponential gating), per arXiv:2405.04517 (port of repro/models/xlstm.py:
`init_mlstm` :22, `mlstm_init_state` :39, `_mlstm_cell` :48,
`_mlstm_inputs` :65, `_carry_through` :78, `mlstm_forward` :89,
`mlstm_decode` :120, `init_slstm` :135, `slstm_init_state` :149,
`_slstm_cell` :155, `slstm_forward` :170, `slstm_decode` :196).

The time recurrences are sequential, as the reference's `lax.scan` is: a
Python loop over steps. The stabilizer `m` starts at -inf. No Pallas
kernel reaches this module in the reference, so it stays plain PyTorch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, dense_init, init_mlp, mlp, torch_dtype


# ------------------------------------------------------------------ mLSTM
def _m_dims(cfg):
    di = int(cfg.xlstm.proj_factor_m * cfg.d_model)
    h = cfg.n_heads
    return di, h, di // h


def init_mlstm(gen: torch.Generator, cfg, lead=()) -> Params:
    di, h, _ = _m_dims(cfg)
    d = cfg.d_model
    dt = torch_dtype(cfg.param_dtype)
    return {
        "up": dense_init(gen, (d, 2 * di), dt, lead=lead),
        "wq": dense_init(gen, (di, di), dt, lead=lead),
        "wk": dense_init(gen, (di, di), dt, lead=lead),
        "wv": dense_init(gen, (di, di), dt, lead=lead),
        "wi": dense_init(gen, (di, h), dt, lead=lead),
        "wf": dense_init(gen, (di, h), dt, lead=lead),
        "wo_gate": dense_init(gen, (di, di), dt, lead=lead),
        "down": dense_init(gen, (di, d), dt, lead=lead),
    }


def mlstm_init_state(cfg, batch: int, device=None):
    _, h, dh = _m_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, h, dh, dh), **f32),
        "n": torch.zeros((batch, h, dh), **f32),
        "m": torch.full((batch, h), float("-inf"), **f32),
    }


def _mlstm_cell(state, q, k, v, ig, fg):
    """One time step. q, k, v: [B, H, dh]; ig, fg: [B, H] (pre-activation logs)."""
    c, n, m = state["C"], state["n"], state["m"]
    dh = q.shape[-1]
    m_new = torch.maximum(fg + m, ig)  # log-space stabilizer
    i_s = torch.exp(ig - m_new)[..., None]
    f_s = torch.exp(fg + m - m_new)[..., None]
    kn = k * (dh ** -0.5)
    c = f_s[..., None] * c + i_s[..., None] * (kn[..., :, None] * v[..., None, :])
    n = f_s * n + i_s * kn
    num = torch.einsum("bhij,bhi->bhj", c, q)
    den = torch.clamp_min(torch.abs(torch.einsum("bhi,bhi->bh", n, q)), 1.0)
    return {"C": c, "n": n, "m": m_new}, num / den[..., None]


def _mlstm_inputs(p: Params, cfg, x):
    _, h, dh = _m_dims(cfg)
    up = torch.einsum("bsd,de->bse", x, p["up"])
    xm, z = up.chunk(2, dim=-1)
    lead = xm.shape[:2]
    q = torch.einsum("bse,ef->bsf", xm, p["wq"]).reshape(*lead, h, dh)
    k = torch.einsum("bse,ef->bsf", xm, p["wk"]).reshape(*lead, h, dh)
    v = torch.einsum("bse,ef->bsf", xm, p["wv"]).reshape(*lead, h, dh)
    ig = torch.einsum("bse,eh->bsh", xm, p["wi"]).float()
    fg = torch.einsum("bse,eh->bsh", xm, p["wf"]).float()
    og = torch.sigmoid(torch.einsum("bse,ef->bsf", xm, p["wo_gate"]).float())
    return q, k, v, ig, fg, og, z


def _carry_through(new_state, old_state, live_t):
    """Per-row select: pad steps keep the old recurrent state. live_t: [B]."""
    return {key: torch.where(live_t.reshape((-1,) + (1,) * (nv.ndim - 1)), nv,
                             old_state[key])
            for key, nv in new_state.items()}


def mlstm_forward(p: Params, cfg, x: torch.Tensor, return_state: bool = False,
                  token_mask: torch.Tensor | None = None):
    """x: [B, S, D] from the init state. token_mask [B, S]: pad steps carry
    {C, n, m} through unchanged, so the final state equals an unpadded
    forward of each row's real prefix."""
    di, _, _ = _m_dims(cfg)
    b, s, _ = x.shape
    q, k, v, ig, fg, og, z = _mlstm_inputs(p, cfg, x)
    q, k, v = q.float(), k.float(), v.float()
    st = mlstm_init_state(cfg, b, x.device)
    hs = []
    for t in range(s):
        new, h_t = _mlstm_cell(st, q[:, t], k[:, t], v[:, t], ig[:, t], fg[:, t])
        st = new if token_mask is None else _carry_through(new, st, token_mask[:, t])
        hs.append(h_t)
    hseq = torch.stack(hs, dim=1).reshape(b, s, di)
    y = (hseq * og).to(x.dtype) * F.silu(z.float()).to(x.dtype)
    out = torch.einsum("bse,ed->bsd", y, p["down"])
    return (out, st) if return_state else out


def mlstm_decode(p: Params, cfg, x, state):
    """Single-token step. x: [B, 1, D]; state: {C, n, m}."""
    di, _, _ = _m_dims(cfg)
    b = x.shape[0]
    q, k, v, ig, fg, og, z = _mlstm_inputs(p, cfg, x)
    st, h_t = _mlstm_cell(state, q[:, 0].float(), k[:, 0].float(), v[:, 0].float(),
                          ig[:, 0], fg[:, 0])
    y = (h_t.reshape(b, di) * og[:, 0]).to(x.dtype)
    y = y * F.silu(z[:, 0].float()).to(x.dtype)
    return torch.einsum("be,ed->bd", y, p["down"])[:, None], st


# ------------------------------------------------------------------ sLSTM
def init_slstm(gen: torch.Generator, cfg, lead=()) -> Params:
    d = cfg.d_model
    dt = torch_dtype(cfg.param_dtype)
    f = cfg.xlstm.proj_factor_s
    d_ff = max(128, int(2 * f * d + 127) // 128 * 128)  # 128-aligned, as the reference
    return {
        "w_in": dense_init(gen, (d, 4 * d), dt, lead=lead),  # i, f, z, o input weights
        "r": dense_init(gen, (d, 4 * d), dt, scale=d ** -0.5, lead=lead),  # recurrent
        "b": torch.zeros((*lead, 4 * d), dtype=torch.float32, device=gen.device),
        "ffn": init_mlp(gen, d, d_ff, dt, lead),
    }


def slstm_init_state(cfg, batch: int, device=None):
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d), **f32), "n": torch.zeros((batch, d), **f32),
            "h": torch.zeros((batch, d), **f32),
            "m": torch.full((batch, d), float("-inf"), **f32)}


def _slstm_cell(p: Params, st, x_t):
    """x_t: [B, 4D] input pre-activations; the recurrent term is added here."""
    rec = torch.einsum("bd,de->be", st["h"].to(x_t.dtype), p["r"].to(x_t.dtype))
    g = (x_t + rec).float() + p["b"]
    ig, fg, zg, og = g.chunk(4, dim=-1)
    m_new = torch.maximum(fg + st["m"], ig)
    i_s = torch.exp(ig - m_new)
    f_s = torch.exp(fg + st["m"] - m_new)
    c = f_s * st["c"] + i_s * torch.tanh(zg)
    n = f_s * st["n"] + i_s
    h = torch.sigmoid(og) * c / torch.clamp_min(n, 1.0)
    return {"c": c, "n": n, "h": h, "m": m_new}


def slstm_forward(p: Params, cfg, x: torch.Tensor, return_state: bool = False,
                  token_mask: torch.Tensor | None = None):
    """x: [B, S, D] from the init state. token_mask [B, S]: pad steps carry
    {c, n, h, m} through unchanged (see mlstm_forward)."""
    b, s, _ = x.shape
    xin = torch.einsum("bsd,de->bse", x, p["w_in"])
    st = slstm_init_state(cfg, b, x.device)
    hs = []
    for t in range(s):
        new = _slstm_cell(p, st, xin[:, t])
        st = new if token_mask is None else _carry_through(new, st, token_mask[:, t])
        hs.append(st["h"])
    h = torch.stack(hs, dim=1).to(x.dtype)
    out = h + mlp(p["ffn"], h)
    return (out, st) if return_state else out


def slstm_decode(p: Params, cfg, x, state):
    """Single-token step. x: [B, 1, D]; state: {c, n, h, m}."""
    xin = torch.einsum("bsd,de->bse", x, p["w_in"])[:, 0]
    st = _slstm_cell(p, state, xin)
    h = st["h"].to(x.dtype)[:, None]
    return h + mlp(p["ffn"], h), st
