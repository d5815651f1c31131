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
PyTorch. `mamba_forward_mesh` / `mamba_decode_mesh` run the block
channel-parallel on a device mesh (see the section at the end).
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


def _ssm_inputs(p: Params, cfg, x: torch.Tensor, z: torch.Tensor, conv_state=None,
                reduce=None):
    """Shared pre-scan computation on C channels: x, z [B, S, C] the
    in-projection's halves (C = Di, or a mesh rank's Di/m, whose conv,
    dt_proj, dt_bias, A_log and D leaves `p` then holds: only x_proj's
    product crosses channels, and `reduce` sums its partial products over
    the ranks). The trailing `xc` is the conv input with its causal pad
    prepended: masked prefill gathers per-row conv states out of it."""
    mc, _, dtr = _dims(cfg)
    dtype, c = x.dtype, x.shape[-1]
    # causal depthwise conv over time, tap by tap in the parameter dtype
    pad = (torch.zeros((x.shape[0], mc.d_conv - 1, c), dtype=x.dtype, device=x.device)
           if conv_state is None else conv_state)
    xc = torch.cat([pad, x], dim=1)
    new_conv_state = xc[:, -(mc.d_conv - 1):, :] if mc.d_conv > 1 else pad
    s = x.shape[1]
    x = sum(xc[:, i:i + s, :] * p["conv_w"][i] for i in range(mc.d_conv)) + p["conv_b"]
    x = F.silu(x.float()).to(dtype)

    proj = torch.einsum("bsi,ie->bse", x, p["x_proj"])
    if reduce is not None:
        proj = reduce(proj)
    dt_in, b_ssm, c_ssm = torch.split(proj, [dtr, mc.d_state, mc.d_state], dim=-1)
    dt = _softplus(torch.einsum("bsr,ri->bsi", dt_in, p["dt_proj"]).float()
                   + p["dt_bias"].float())  # [B, S, C] fp32
    a = -torch.exp(p["A_log"])  # [C, N] fp32
    abar = torch.exp(dt[..., None] * a)  # [B, S, C, N]
    bx = (dt * x.float())[..., None] * b_ssm.float()[:, :, None, :]  # [B, S, C, N]
    return x, z, abar, bx, c_ssm, new_conv_state, xc


def _in_proj(p: Params, xz: torch.Tensor):
    """(x, z) [B, S, Di] each: the in-projection's two halves."""
    return torch.einsum("bsd,de->bse", xz, p["in_proj"]).chunk(2, dim=-1)


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
    y, state = _forward(p, cfg, *_in_proj(p, xz), chunk, token_mask)
    out = torch.einsum("bsi,id->bsd", y, p["out_proj"])
    return (out, state) if return_state else out


def _forward(p: Params, cfg, x, z, chunk: int, token_mask, reduce=None):
    """`mamba_forward` on the in-projection's halves x, z [B, S, C] (see
    `_ssm_inputs`): (the gated output [B, S, C] before out_proj, the final
    {ssm [B, C, N], conv [B, d_conv - 1, C]})."""
    mc = cfg.mamba
    b, s, c = x.shape
    dtype = x.dtype
    x, z, abar, bx, c_ssm, new_conv, xc = _ssm_inputs(p, cfg, x, z, reduce=reduce)
    if token_mask is not None:
        live = token_mask[..., None, None]  # [B, S, 1, 1]
        abar = torch.where(live, abar, torch.ones_like(abar))  # identity on pads
        bx = torch.where(live, bx, torch.zeros_like(bx))

    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    h0 = torch.zeros((b, c, mc.d_state), dtype=torch.float32, device=x.device)
    hs = []
    for c0 in range(0, s, chunk):
        a_cum, b_cum = _assoc_scan(abar[:, c0:c0 + chunk], bx[:, c0:c0 + chunk])
        h = b_cum + a_cum * h0[:, None]  # [B, c, C, N]
        h0 = h[:, -1]
        hs.append(h)
    h = torch.cat(hs, dim=1) if len(hs) > 1 else hs[0]

    y = torch.einsum("bsin,bsn->bsi", h, c_ssm.float())
    y = y + p["D"] * x.float()
    y = y.to(dtype) * F.silu(z.float()).to(dtype)
    if token_mask is not None and mc.d_conv > 1:
        # input position t sits at xc index t + d_conv - 1, so the window
        # of positions [L - d_conv + 1, L - 1] is xc[L : L + d_conv - 1]
        # (short rows reach into the zero pad, as unpadded ones do)
        lengths = token_mask.sum(-1)
        gidx = lengths[:, None] + torch.arange(mc.d_conv - 1, device=x.device)[None, :]
        new_conv = torch.take_along_dim(xc, gidx[..., None], dim=1)
    return y, {"ssm": h0, "conv": new_conv}


def mamba_init_state(cfg, batch: int, dtype, device=None):
    mc, di, _ = _dims(cfg)
    return {
        "ssm": torch.zeros((batch, di, mc.d_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, mc.d_conv - 1, di), dtype=dtype, device=device),
    }


def mamba_decode(p: Params, cfg, xz: torch.Tensor, state):
    """Single-token step. xz: [B, 1, D]; state: {ssm, conv}."""
    y, new = _decode(p, cfg, *_in_proj(p, xz), state)
    return torch.einsum("bi,id->bd", y, p["out_proj"])[:, None, :], new


def _decode(p: Params, cfg, x, z, state, reduce=None):
    """`mamba_decode` on the in-projection's halves x, z [B, 1, C]: (the
    gated output [B, C] before out_proj, the new {ssm, conv})."""
    dtype = x.dtype
    x, z, abar, bx, c_ssm, new_conv, _ = _ssm_inputs(p, cfg, x, z, state["conv"], reduce)
    h = abar[:, 0] * state["ssm"] + bx[:, 0]  # [B, C, N]
    y = torch.einsum("bin,bn->bi", h, c_ssm[:, 0].float())
    y = y + p["D"] * x[:, 0].float()
    y = y.to(dtype) * F.silu(z[:, 0].float()).to(dtype)
    return y, {"ssm": h, "conv": new_conv}


# ------------------------------------------------------ on a device mesh
# Channel-parallel, as the reference's rules place the leaves
# (repro/distributed/sharding.py:109-124) and `cache_pspec` the state:
# in_proj's columns, conv_w / conv_b / dt_bias / D, A_log's and x_proj's
# and out_proj's rows, dt_proj's columns, ssm [B, Di, N] and conv
# [B, d_conv - 1, Di] all split Di over "model" in rank order, so the
# scan and the depthwise conv are local. The collectives: in_proj's
# regroup ([x | z] column chunks to this rank's channels of each half,
# `tpl.block_cols`), one all-reduce of x_proj's partial (dt_in, B, C)
# [B, S, dtr + 2N], and out_proj's row-parallel sum. In training the
# split comes from the rules' layout of a state the step never allocates
# (its `Local`s on the meta device), and the forward starts from zeros.
def _mesh_leaves(tp, p, state):
    """(split, {leaf: this rank's tensor}): whether "model" splits the
    channels, and the per-channel leaves (x_proj's rows) as held; the
    state (`Local`s) must split as they do."""
    split = "model" in p["conv_b"].axes
    if state["ssm"].axes.get("model", 1) != 1 or state["conv"].axes.get("model", 2) != 2 \
            or any(("model" in state[k].axes) != split for k in ("ssm", "conv")):
        raise ValueError(f"mamba state split as {state['ssm'].axes}, {state['conv'].axes}; "
                         f"conv_b as {p['conv_b'].axes}")
    out = {}
    for k in ("conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias", "A_log", "D"):
        w, dm, idx = tp.weight(p[k])
        if (dm is not None) != split or idx is not None:
            raise ValueError(f"mamba {k} split as {p[k].axes}, conv_b as {p['conv_b'].axes}")
        out[k] = w
    return split, out


def _mesh_in(tp, p, xz, state):
    from repro_torch.distributed import tensor_parallel as tpl

    split, lp = _mesh_leaves(tp, p, state)
    x, z = tpl.block_cols(tp, xz, p["in_proj"], 2, split).unbind(-2)
    # x_proj's (dt_in, B, C) partial sums feed this rank's channels only
    return split, lp, x, z, (tp.sum_copy_model if split else None)


def _mesh_out(tp, p, y, split: bool):
    """out_proj's rows (this rank's channels) summed over "model"."""
    w, dm, _ = tp.weight(p["out_proj"])
    if (dm == 0) != split:
        raise ValueError(f"mamba out_proj split as {p['out_proj'].axes}")
    out = y @ w
    return tp.sum_model(out) if split else out


def mamba_forward_mesh(tp, p, cfg, xz: torch.Tensor, state, token_mask=None,
                       chunk: int = 128):
    """`mamba_forward(..., return_state=True)` on a mesh (p's leaves
    `Local`, xz [B, S, D] this rank's rows, `state` the rows' cache leaves:
    their layout; the forward starts from the zero state): (out [B, S, D],
    the final state on this rank's C channels {ssm [B, C, N], conv [B,
    d_conv - 1, C]})."""
    split, lp, x, z, reduce = _mesh_in(tp, p, xz, state)
    y, new = _forward(lp, cfg, x, z, chunk, token_mask, reduce)
    return _mesh_out(tp, p, y, split), new


def mamba_decode_mesh(tp, p, cfg, xz: torch.Tensor, state):
    """`mamba_decode` on a mesh: `state` the rows' {ssm, conv} shards."""
    split, lp, x, z, reduce = _mesh_in(tp, p, xz, state)
    y, new = _decode(lp, cfg, x, z, {k: state[k].t for k in ("ssm", "conv")}, reduce)
    return _mesh_out(tp, p, y, split)[:, None, :], new
