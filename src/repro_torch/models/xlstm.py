"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory with
exponential gating), per arXiv:2405.04517 (port of repro/models/xlstm.py:
`init_mlstm` :22, `mlstm_init_state` :39, `_mlstm_cell` :48,
`_mlstm_inputs` :65, `_carry_through` :78, `mlstm_forward` :89,
`mlstm_decode` :120, `init_slstm` :135, `slstm_init_state` :149,
`_slstm_cell` :155, `slstm_forward` :170, `slstm_decode` :196).

The time recurrences are sequential, as the reference's `lax.scan` is: a
Python loop over steps. The stabilizer `m` starts at -inf. No Pallas
kernel reaches this module in the reference, so it stays plain PyTorch.
The `*_mesh` functions run both blocks on a device mesh, the state split
as `cache_pspec` places it (see the section at the end).
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
    st, num, nq = _mlstm_update(state, q, k, v, ig, fg, q.shape[-1])
    return st, num / _mlstm_den(nq)[..., None]


def _mlstm_update(state, q, k, v, ig, fg, dh: int):
    """A step's new state and its readout's sums over the key index i:
    (state, num [B, H, dh] = sum_i C[i, j] q_i, nq [B, H] = n . q). q and
    k may hold a slice of the key index (a mesh rank's), v all of it."""
    c, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(fg + m, ig)  # log-space stabilizer
    i_s = torch.exp(ig - m_new)[..., None]
    f_s = torch.exp(fg + m - m_new)[..., None]
    kn = k * (dh ** -0.5)
    c = f_s[..., None] * c + i_s[..., None] * (kn[..., :, None] * v[..., None, :])
    n = f_s * n + i_s * kn
    num = torch.einsum("bhij,bhi->bhj", c, q)
    return {"C": c, "n": n, "m": m_new}, num, torch.einsum("bhi,bhi->bh", n, q)


def _mlstm_den(nq: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(torch.abs(nq), 1.0)


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
    return _slstm_gates(st, (x_t + rec).float() + p["b"])


def _slstm_gates(st, g):
    """The step from the gate pre-activations g [B, 4C] ([i | f | z | o] on
    the C channels `st` holds: all, or a mesh rank's)."""
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


# ------------------------------------------------------ on a device mesh
# mLSTM (reference rules: the generic fallback): wq / wk / wv / wo_gate /
# wi / wf / down split along their rows, the contracting Di, so the
# projections are partial sums; `up` [D, 2 Di] is column-split and
# regrouped to this rank's channels of x and z. The state splits as
# `cache_pspec` places it: over heads where they divide "model", else C
# and n along the key index i (m [B, H] whole). A rank needs q and k at
# its (head, i) pairs, v at its heads' every j, the gates at its heads
# and o at its Di/m channels: one reduce-scatter of the pieces only it
# needs and, in the key layout, one all-reduce of those every rank needs
# (v, the gates). The readout sums over i: in the key layout every
# step's partial (num, n . q) is all-reduced once a call, and |.| and the
# clamp apply after that sum.
def _mlstm_layout(tp, cfg, state):
    """(heads, key indices this rank holds, "heads" | "keys" | None) as
    "model" splits C [B, H, dh, dh] (a scan group's `Local`)."""
    _, h, dh = _m_dims(cfg)
    d = state["C"].axes.get("model")
    want = {None: (None, None), 1: (1, 1), 2: (2, None)}
    if d not in want or (state["n"].axes.get("model"), state["m"].axes.get("model")) != want[d]:
        raise ValueError(f"mLSTM state split as {state['C'].axes}, {state['n'].axes}, "
                         f"{state['m'].axes}")
    if d == 1:
        return h // tp.m, dh, "heads"
    if d == 2:
        return h, dh // tp.m, "keys"
    return h, dh, None


# the projections' columns each rank needs on its own, by layout; the
# others every rank needs whole
_OWN = {"heads": "qkvoif", "keys": "qko", None: "o"}


def _rank_pieces(t: torch.Tensor, name: str, kind, m: int, h: int) -> torch.Tensor:
    """A projection t [..., W] as [..., m, W/m]: rank r's columns of it at
    r (q / k at its (head, i) pairs, v / i / f at its heads, o at its
    channels), head-major as the rank computes with them."""
    if kind == "keys" and name in "qk":  # [h, m, dh/m]: rank r's i-slice of every head
        return t.unflatten(-1, (h, m, -1)).movedim(-2, -3).flatten(-2)
    return t.unflatten(-1, (m, -1))


def _mlstm_mesh(tp, p, cfg, x, state, token_mask=None, init: bool = False):
    """The mLSTM block over x [B, S, D] (this rank's rows) from `state`
    (a scan group's `Local` leaves; with `init` the init state, their
    layout only): (out [B, S, D], this rank's new {C, n, m})."""
    from repro_torch.distributed import tensor_parallel as tpl

    di, h, dh = _m_dims(cfg)
    nh, ni, kind = _mlstm_layout(tp, cfg, state)
    b, s, _ = x.shape
    w = {k: tp.weight(p[k]) for k in ("wq", "wk", "wv", "wo_gate", "wi", "wf", "down")}
    split = w["wq"][1] == 0
    if any((dm == 0) != split or idx is not None for _, dm, idx in w.values()):
        raise ValueError(f"mLSTM projections split as {[p[k].axes for k in w]}")
    c = di // tp.m if split else di  # this rank's channels of Di
    xm, z = tpl.block_cols(tp, x, p["up"], 2, split).unbind(-2)
    comps = {n: xm @ w[k][0] for n, k in zip("qkvoif", ("wq", "wk", "wv", "wo_gate", "wi",
                                                         "wf"))}
    own = _OWN[kind] if split else "qkvoif"
    common = [n for n in "qkvoif" if n not in own]
    if split:  # partial sums: this rank's pieces reduce-scattered, the rest all-reduced
        pieces = torch.cat([_rank_pieces(comps[n], n, kind, tp.m, h) for n in own], -1)
        mine = tp.reduce_scatter(pieces.movedim(-2, 0), (tp.model, tp.m, tp.mi))[0]
        widths = [comps[n].shape[-1] // tp.m for n in own]
        got = dict(zip(own, mine.split(widths, -1)))
        if common:  # the key layout's recurrence is rank-specific: both ways summed
            total = tp.sum_copy_model if kind == "keys" else tp.sum_model
            shared = total(torch.cat([comps[n] for n in common], -1))
            got.update(zip(common, shared.split([comps[n].shape[-1] for n in common], -1)))
    else:
        got = comps
    q = got["q"].float().unflatten(-1, (nh, ni))
    k = got["k"].float().unflatten(-1, (nh, ni))
    v = got["v"].float().unflatten(-1, (nh, dh))
    ig, fg, og = got["i"].float(), got["f"].float(), torch.sigmoid(got["o"].float())

    f32 = dict(dtype=torch.float32, device=x.device)
    st = ({"C": torch.zeros((b, nh, ni, dh), **f32), "n": torch.zeros((b, nh, ni), **f32),
           "m": torch.full((b, nh), float("-inf"), **f32)}
          if init else {key: state[key].t for key in ("C", "n", "m")})
    nums, nqs = [], []
    for t in range(s):
        new, num, nq = _mlstm_update(st, q[:, t], k[:, t], v[:, t], ig[:, t], fg[:, t], dh)
        st = new if token_mask is None else _carry_through(new, st, token_mask[:, t])
        nums.append(num)
        nqs.append(nq)
    num, nq = torch.stack(nums, 1), torch.stack(nqs, 1)  # [B, S, nh, dh], [B, S, nh]
    if kind == "keys":  # partial over i: one sum a call, |.| and the clamp after it
        tot = tp.sum_model(torch.cat([num, nq[..., None]], -1))
        num, nq = tot[..., :-1], tot[..., -1]
    hseq = (num / _mlstm_den(nq)[..., None]).reshape(b, s, nh * dh)
    if c < nh * dh:  # every head's channels here: this rank's Di/m of them
        hseq = tp.copy_model(hseq).narrow(-1, tp.mi * c, c)
    y = (hseq * og).to(x.dtype) * F.silu(z.float()).to(x.dtype)
    out = y @ w["down"][0]
    return (tp.sum_model(out) if split else out), st


def mlstm_forward_mesh(tp, p, cfg, x, state, token_mask=None):
    """`mlstm_forward(..., return_state=True)` on a mesh: x [B, S, D] this
    rank's rows, `state` the rows' cache leaves (their layout; the forward
    starts from the init state). Returns (out, this rank's {C, n, m})."""
    return _mlstm_mesh(tp, p, cfg, x, state, token_mask, init=True)


def mlstm_decode_mesh(tp, p, cfg, x, state):
    """`mlstm_decode` on a mesh: x [B, 1, D], `state` this rank's shards."""
    return _mlstm_mesh(tp, p, cfg, x, state)


# sLSTM: w_in, r [D, 4 D] and b [4 D] column-split (the generic fallback),
# so a rank holds gate columns; c, n, h, m [B, D] split D over "model".
# The gates are regrouped to this rank's channels of each of i, f, z, o
# once a call: in prefill the weights (`tpl.block_cols` / `block_weight`),
# in decode the step's pre-activations (x w_in + h r + b on the local
# columns, one all-to-all of [B, 4D/m]). Every step needs the whole h for
# h @ r: one all-gather of [B, D] a step, which the recurrence cannot
# avoid. The block's FFN runs column- then row-parallel.
def _slstm_mesh(tp, p, cfg, x, state, token_mask=None, init: bool = False):
    from repro_torch.distributed import tensor_parallel as tpl

    split = "model" in state["c"].axes
    if any(("model" in state[k].axes) != split for k in ("n", "h", "m")):
        raise ValueError(f"sLSTM state split as {[state[k].axes for k in 'cnhm']}")
    b, s, d = x.shape
    dt = x.dtype
    if init:
        c = d // tp.m if split else d
        f32 = dict(dtype=torch.float32, device=x.device)
        st = {"c": torch.zeros((b, c), **f32), "n": torch.zeros((b, c), **f32),
              "h": torch.zeros((b, c), **f32), "m": torch.full((b, c), float("-inf"), **f32)}
        h = torch.zeros((b, d), **f32)
    else:
        st = {key: state[key].t for key in ("c", "n", "h", "m")}
        h = tp.gather_model(st["h"], -1) if split else st["h"]
    if s == 1 and split:  # decode: the pre-activations regrouped
        w = {k: tp.weight(p[k]) for k in ("w_in", "r", "b")}
        if any(dm != len(p[k].shape) - 1 or idx is not None for k, (_, dm, idx) in w.items()):
            raise ValueError(f"sLSTM gates split as {[p[k].axes for k in w]}")
        g = (x[:, 0] @ w["w_in"][0] + h.to(dt) @ w["r"][0].to(dt)).float() + w["b"][0]
        g = tp.regroup_model(g.unflatten(-1, (4, -1)).movedim(-2, 0)).movedim(0, -2)

        def pre(t, h):
            return g.flatten(-2)
    else:
        xin = tpl.block_cols(tp, x, p["w_in"], 4, split).flatten(-2)  # [B, S, 4C]
        r = tpl.block_weight(tp, p["r"], 4, split).flatten(-2).to(dt)
        bias = tpl.block_weight(tp, p["b"], 4, split).flatten(-2)

        def pre(t, h):  # the whole h against this rank's gate columns
            h = tp.copy_model(h) if split else h
            return (xin[:, t] + h.to(dt) @ r).float() + bias
    hs = []
    for t in range(s):
        new = _slstm_gates(st, pre(t, h))
        st = new if token_mask is None else _carry_through(new, st, token_mask[:, t])
        h = tp.gather_model(st["h"], -1) if split else st["h"]
        hs.append(h)
    h = torch.stack(hs, dim=1).to(dt)
    return h + tpl.mlp(tp, p["ffn"], h), st


def slstm_forward_mesh(tp, p, cfg, x, state, token_mask=None):
    """`slstm_forward(..., return_state=True)` on a mesh (see `_mlstm_mesh`
    for the arguments): (out [B, S, D], this rank's {c, n, h, m})."""
    return _slstm_mesh(tp, p, cfg, x, state, token_mask, init=True)


def slstm_decode_mesh(tp, p, cfg, x, state):
    """`slstm_decode` on a mesh: x [B, 1, D], `state` this rank's shards."""
    return _slstm_mesh(tp, p, cfg, x, state)
