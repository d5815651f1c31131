"""Routed-MoE pieces the serving path uses (port of repro/models/moe.py:
`init_moe` :61, `router_topk` :82, `moe_backend` :90, `expert_ffn` :109,
`shared_ffn` :129). The flat training `moe_forward` is a later slice.

The expert FFN over dispatched buffers routes by shape: decode buffers
(S == 1, a few tokens per expert, weight-read bound) go to the batched
expert GEMV (kernels/expert_gemv), everything else to the grouped MoE
GEMM (kernels/moe_gemm). Either resolves CUDA kernel vs plain version
through kernels/backend.py with `cfg.moe_backend`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.expert_gemv import cold_expert_ffn
from repro_torch.kernels.moe_gemm import grouped_expert_ffn
from repro_torch.models.layers import Params, dense_init, torch_dtype


def init_moe(gen: torch.Generator, cfg, lead=()) -> Params:
    mo = cfg.moe
    d, f, e = cfg.d_model, mo.d_expert, mo.n_experts
    dt = torch_dtype(cfg.param_dtype)
    p = {
        "router": dense_init(gen, (d, e), torch.float32, lead=lead),
        "w_gate": dense_init(gen, (e, d, f), dt, lead=lead),
        "w_up": dense_init(gen, (e, d, f), dt, lead=lead),
        "w_down": dense_init(gen, (e, f, d), dt, lead=lead),
    }
    if mo.n_shared:
        p["shared"] = {
            "w_gate": dense_init(gen, (mo.n_shared, d, f), dt, lead=lead),
            "w_up": dense_init(gen, (mo.n_shared, d, f), dt, lead=lead),
            "w_down": dense_init(gen, (mo.n_shared, f, d), dt, lead=lead),
        }
    return p


def router_topk(logits: torch.Tensor, k: int):
    """Softmax-then-topk with renormalized weights (DeepSeek-style)."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return probs, w, idx


def moe_backend(cfg, backend: str | None = None) -> str:
    """The expert-FFN backend choice: an explicit `backend` overrides
    `cfg.moe_backend` (validated by the kernels/backend.py rule)."""
    return resolve_backend(backend or cfg.moe_backend, knob="moe_backend")


def expert_ffn(h, w_gate, w_up, w_down, *, backend: str = "auto",
               decode: bool = False) -> torch.Tensor:
    """Expert FFN over dispatched buffers h [G, C, D] with weights
    w_gate/w_up [G, D, F], w_down [G, F, D] (any strides): decode
    buffers hit the batched GEMV, everything else the grouped GEMM."""
    if decode:
        return cold_expert_ffn(h, w_gate, w_up, w_down, backend=backend)
    return grouped_expert_ffn(h, w_gate, w_up, w_down, backend=backend)


def shared_ffn(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = torch.einsum("bsd,edf->bsef", x, p["w_gate"])
    u = torch.einsum("bsd,edf->bsef", x, p["w_up"])
    a = F.silu(g.float()).to(x.dtype) * u
    return torch.einsum("bsef,efd->bsd", a, p["w_down"])
