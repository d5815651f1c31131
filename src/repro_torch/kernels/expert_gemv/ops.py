"""Batched cold-expert execution, one NDP per expert (port of
repro/kernels/expert_gemv/ops.py:23-54, `cold_expert_ffn`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.backend import kernel_span
from repro_torch.kernels.expert_gemv.kernel import expert_ffn_gemv, panel_width


def cold_expert_ffn(x, w1, w3, w2, *, backend: str = "auto"):
    """x [E, C, D] per-expert token buffers (C small); w1/w3 [E, D, F];
    w2 [E, F, D] -> [E, C, D].

    In fp32, F is zero-padded up to a multiple of the kernel's F panel
    when it does not divide (exact: silu(0) * 0 = 0 through the
    zero-padded down rows), so any expert width works. The bf16 kernel
    reads ragged panels in place (TMA zero-fills them), and W2 in place
    in either layout: a tier buffer's transposed view or a row-major
    [E, F, D] parameter (the flat MoE's decode step)."""
    with kernel_span("cold_expert_ffn", x):
        f = w1.shape[-1]
        bf = panel_width(f)
        if x.dtype == torch.float32 and f % bf:
            f_pad = (f + bf - 1) // bf * bf
            w1 = F.pad(w1, (0, f_pad - f))
            w3 = F.pad(w3, (0, f_pad - f))
            w2 = F.pad(w2, (0, 0, 0, f_pad - f))
        return expert_ffn_gemv(x.contiguous(), w1, w3, w2, backend=backend)
