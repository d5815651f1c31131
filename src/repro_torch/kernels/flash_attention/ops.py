"""Model-layout entry point of flash attention (port of
repro/kernels/flash_attention/ops.py:24): [B, S, H, hd] in and out,
reshaped to the kernel's [B*H, S, hd]."""
from __future__ import annotations

import torch

from repro_torch.kernels.backend import kernel_span
from repro_torch.kernels.flash_attention.kernel import flash_attention


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
        bq: int = 256, bk: int = 256, backend: str = "auto") -> torch.Tensor:
    """q: [B, Sq, H, hd]; k, v: [B, Sk, H, hd] (GQA expanded by the caller)
    -> [B, Sq, H, hd] in q's dtype. `bq` / `bk` are the TPU kernel's query
    and key tile sizes, kept for call parity with the JAX `mha`: the CUDA
    kernels tile the work their own way (bf16: 128 query rows by 128
    keys; fp32: 64 by 32) whatever they are, mask their own ragged edge,
    and so need no length to divide a tile."""
    if bq < 1 or bk < 1:
        raise ValueError(f"mha: tile sizes must be positive, got bq={bq}, bk={bk}")
    b, sq, h, dh = q.shape

    def heads_first(t):
        return t.transpose(1, 2).reshape(b * h, t.shape[1], dh).contiguous()

    with kernel_span("mha", backend, q):
        o = flash_attention(heads_first(q), heads_first(k), heads_first(v), causal=causal,
                            backend=backend)
    return o.reshape(b, h, sq, dh).transpose(1, 2)
