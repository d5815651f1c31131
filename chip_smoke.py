"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA H100.

  python3 chip_smoke.py            # what CI runs: build, kernel phases, serve
  python3 chip_smoke.py --profile  # also a torch.profiler window of each serve
                                   # (full tables: --profile-out PATH, one file
                                   # per model, named PATH's stem-<arch>)

Phases, each fatal on failure:
  1. build the five CUDA kernels from src/repro_torch/csrc (nvcc, sm_90a)
     and count the tensor-core instructions in each library's SASS: the
     bf16 moe_gemm, flash_attention, paged GQA and paged MLA kernels
     must have HGMMA (wgmma), the expert GEMV HMMA (mma.sync);
  2. hold each kernel against its plain PyTorch version at its path's
     shapes, in bf16 and fp32, and time kernel / plain / library on the
     device (CUDA-graph replay), plus the kernel's eager call;
  3. drive flash attention's entry point `mha` with the launch counters
     reset just before;
  4. serve granite-moe-1b-a400m (GQA) at full width and depth, then
     deepseek-v2-236b (MLA, dense layer 0, shared experts) at full width
     with its depth cut to 3 layers (bf16, seeded random weights),
     through ServingLoop with the kernel launch counters reset just
     before each, and check every request completed and every kernel of
     the path ran (and the other attention kernel did not);
  5. serve each smoke-size model at fp32 on the card (kernels) and on the
     CPU (plain versions) from the same weights: tokens must agree.
Prints one JSON line per phase, the `kernels` JSON line, the card's name
and power limit, and last the `ok` JSON line. Imports nothing of JAX:
the machine with the card has none.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.expert_gemv import expert_ffn_gemv, gemv_rounding_bound  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    mha,
    rounding_bound,
)
from repro_torch.kernels.moe_gemm import moe_gemm  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    gqa_rounding_bound,
    linearize_blocks,
    paged_prefill_gqa,
    paged_prefill_mla,
)
from repro_torch.kernels.paged_attention.kernel import _launch as gqa_launch  # noqa: E402
from repro_torch.kernels.paged_attention.kernel import _launch_mla as mla_launch  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serving.batching import Request  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    fill_tiers_from_params,
    init_tiered_for_model,
)
from repro_torch.serving.loop import ServingLoop  # noqa: E402
from repro_torch.serving.paged_kv import PagedStats  # noqa: E402

HBM_BPS = 3.35e12  # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32
GQA_ARCH = "granite-moe-1b-a400m"
MLA_ARCH = "deepseek-v2-236b"
MLA_LAYERS = 3  # deepseek depth cut 60 -> 3: dense layer 0 + 2 MoE layers
MHA_PATH = "mha"
# source -> the tensor-core instruction its bf16 path must compile to
TENSOR_CORE_KERNELS = {"moe_gemm": "HGMMA", "flash_attention": "HGMMA",
                       "paged_attention": "HGMMA", "paged_attention_mla": "HGMMA",
                       "expert_gemv": "HMMA"}
# name -> (wrapper, source, TPU kernel it replaces, the path it was ported
# on: the `kernels` line's `launches` is that path's own count)
KERNELS = {
    "paged_prefill_gqa": (paged_prefill_gqa, "src/repro_torch/csrc/paged_attention.cu",
                          "src/repro/kernels/paged_attention/paged_attention.py:105", GQA_ARCH),
    "paged_prefill_mla": (paged_prefill_mla, "src/repro_torch/csrc/paged_attention_mla.cu",
                          "src/repro/kernels/paged_attention/paged_attention.py:219", MLA_ARCH),
    "moe_gemm": (moe_gemm, "src/repro_torch/csrc/moe_gemm.cu",
                 "src/repro/kernels/moe_gemm/moe_gemm.py:34", GQA_ARCH),
    "expert_ffn_gemv": (expert_ffn_gemv, "src/repro_torch/csrc/expert_gemv.cu",
                        "src/repro/kernels/expert_gemv/expert_gemv.py:44", GQA_ARCH),
    "flash_attention": (flash_attention, "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/flash_attention.py:66", MHA_PATH),
}
TOL = {  # (atol, rtol) of kernel vs plain version, by dtype
    # fp32: same products, other summation order (k up to 1024 terms)
    torch.float32: (1e-4, 1e-4),
    # bf16 GEMM: the output is rounded to bf16 (8 mantissa bits); the
    # other bf16 kernels are held per element to their rounding bounds
    torch.bfloat16: (3e-2, 3e-2),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _events_ms(run, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def call_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time of one eager call: CUDA events around a loop of calls,
    so the host's cost per call (checks, ctypes, allocation) is in it."""
    for _ in range(warmup):
        fn()
    return _events_ms(fn, iters) / iters


def device_time_ms(fn, arg_sets, calls: int = 32, reps: int = 5) -> float:
    """Mean device time of fn(*args): `calls` calls, cycling over
    `arg_sets`, captured in one CUDA graph whose replays are timed with
    CUDA events. No host work is left between the kernels, and the
    cycled inputs are sized to exceed L2, so each call reads them from
    HBM as the serving path does (every layer has its own weights)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as graphs need
        for args in arg_sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    return _events_ms(graph.replay, reps) / (reps * calls)


def compare(name, got, want, dtype, tol=None):
    """Fail unless |got - want| is within `tol` everywhere: an (atol, rtol)
    pair (default TOL[dtype]) or a tensor of per-element bounds. Returns
    (max abs error, max rel error, largest error / allowed error)."""
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: kernel output has non-finite values")
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if isinstance(tol, torch.Tensor):
        allowed = tol.float()
    else:
        atol, rtol = tol or TOL[dtype]
        allowed = atol + rtol * w.abs()
    bad = err > allowed
    max_abs = float(err.max())
    max_rel = float((err / w.abs().clamp_min(1e-6)).max())
    if bad.any():
        fail(f"{name} [{dtype}]: {int(bad.sum())} elements off, max abs err {max_abs:.3e}")
    return max_abs, max_rel, float((err / allowed.clamp_min(1e-30)).max())


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    tb, tf = nbytes / HBM_BPS * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# --------------------------------------------------------- kernel phases
L2_BYTES = 50 * 2 ** 20  # H100 SXM L2 cache
MAX_SETS = 32  # input sets cycled through by the timed graph


def attention_case(dtype, *, b, c, nb, past, dev, gen):
    """Random pools and tables at the serving shapes: Kv=8, G=2, hd=64,
    bs=4, each row's blocks a random permutation of the pool. Library:
    SDPA over the linearized, head-expanded K/V with the position mask.
    bf16 is held to `gqa_rounding_bound`; a table of enough key tiles to
    split over is also timed with one split (`unsplit`)."""
    kv, g, hd, bs = 8, 2, 64, 4
    n_blocks = max(8 * 18, b * nb)  # batch 8 x ceil(72 / 4) blocks per slot
    perm = torch.randperm(n_blocks, generator=gen, device="cpu")[: b * nb]
    tables = perm.reshape(b, nb).to(torch.int32).to(dev)
    q = torch.randn(b, c, kv, g, hd, generator=gen).to(dev, dtype)
    pool_k = torch.randn(n_blocks + 1, bs, kv, hd, generator=gen).to(dev, dtype)
    pool_v = torch.randn(n_blocks + 1, bs, kv, hd, generator=gen).to(dev, dtype)
    past_len = torch.tensor(past, dtype=torch.int32, device=dev)
    lengths = torch.full((b,), c, dtype=torch.int32, device=dev)
    args = (q, pool_k, pool_v, tables, past_len, lengths)
    keys = linearize_blocks(pool_k, tables).repeat_interleave(g, dim=2).transpose(1, 2)
    vals = linearize_blocks(pool_v, tables).repeat_interleave(g, dim=2).transpose(1, 2)
    qh = q.reshape(b, c, kv * g, hd).transpose(1, 2)
    qpos = past_len[:, None] + torch.arange(c, device=dev)[None, :]
    mask = (torch.arange(keys.shape[2], device=dev)[None, None, :] <= qpos[:, :, None])[:, None]
    # least work: each walked key block read once per row, q read, out written
    isz = q.element_size()
    walked = sum(min(nb, (p + c - 1) // 4 + 1) * 4 for p in past)
    nbytes = 2 * q.numel() * isz + 2 * walked * kv * hd * isz + tables.numel() * 4
    visible = sum(sum(p + i + 1 for i in range(c)) for p in past)
    bf16 = dtype == torch.bfloat16
    return dict(
        args=args, lib_args=(qh, keys, vals, mask),
        kernel=lambda *a: paged_prefill_gqa(*a, backend="cuda"),
        plain=lambda *a: paged_prefill_gqa(*a, backend="ref"),
        library=lambda qh, k, v, m: F.scaled_dot_product_attention(qh, k, v, attn_mask=m),
        held=sum(t.numel() * t.element_size() for t in args),
        bound=bound_ms(nbytes, 4.0 * visible * kv * g * hd, dtype),
        tol=(lambda: gqa_rounding_bound(*args[:5])) if bf16 else None,
        variants={"unsplit": lambda *a: gqa_launch(*a, splits=1)} if bf16 and nb >= 256 else {},
    )


def moe_gemm_case(dtype, *, n_slots, rows, d, f, pair, dev, gen, calls=32):
    """Hot tier of a prefill chunk: n_slots groups of `rows` real rows
    padded to 128, over a tier buffer [n_slots, 3, d, f]. gate|up
    (k = d, n = 2f) reads its two panels as one; down (k = f, n = d)
    reads the stored [d, f] matrix transposed. Library: torch.bmm over
    the concatenated (or copied) weights."""
    bm = 128
    k, n = (d, 2 * f) if pair else (f, d)
    c_pad = -(-rows // bm) * bm
    buf = (torch.randn(n_slots, 3, d, f, generator=gen) * d ** -0.5).to(dev, dtype)
    x = torch.zeros(n_slots, c_pad, k, dtype=dtype, device=dev)
    x[:, :rows] = torch.randn(n_slots, rows, k, generator=gen).to(dev, dtype)
    x = x.reshape(n_slots * c_pad, k)
    w = (buf[:, 0], buf[:, 1]) if pair else buf[:, 2].transpose(1, 2)
    te = torch.arange(n_slots, dtype=torch.int32, device=dev).repeat_interleave(c_pad // bm)
    wj = torch.cat(list(w), -1) if pair else w.contiguous()
    isz = x.element_size()
    nbytes = (x.numel() + n_slots * k * n + x.shape[0] * n) * isz
    return dict(
        args=(x, w, te), lib_args=(x.reshape(n_slots, c_pad, k), wj),
        kernel=lambda *a: moe_gemm(*a, backend="cuda"),
        plain=lambda *a: moe_gemm(*a, backend="ref"),
        library=torch.bmm,
        held=(buf.numel() + x.numel()) * isz,
        bound=bound_ms(nbytes, 2.0 * x.shape[0] * k * n, dtype),
        calls=calls,
    )


def gemv_case(dtype, *, n_slots, t, dev, gen, d=1024, f=512, live=None, calls=32):
    """One tier of a decode step: n_slots experts, t tokens each, read as
    views of the [n, 3, D, F] tier buffer (down matrix transposed). With
    `live`, only the first `live` slots have tokens and the others' rows
    are zero, as dispatch leaves a slot no token was routed to; the bound
    then counts only the live slots' weight bytes, which is all the work
    the function needs (an all-zero slot's output is exactly zero).
    Library: bmm of the concatenated gate|up, SiLU * up, bmm down. bf16
    is held to `gemv_rounding_bound`."""
    buf = (torch.randn(n_slots, 3, d, f, generator=gen) * d ** -0.5).to(dev, dtype)
    x = torch.randn(n_slots, t, d, generator=gen).to(dev, dtype)
    n_live = n_slots if live is None else live
    x[n_live:] = 0
    w1, w3, w2 = buf[:, 0], buf[:, 1], buf[:, 2].transpose(1, 2)

    def library(x, w13, w2c):
        gu = torch.bmm(x, w13)
        return torch.bmm(F.silu(gu[..., :f]) * gu[..., f:], w2c)

    isz = x.element_size()
    nbytes = (3 * n_live * d * f + 2 * n_live * t * d) * isz
    return dict(
        args=(x, w1, w3, w2), lib_args=(x, torch.cat([w1, w3], -1), w2.contiguous()),
        tol=(lambda: gemv_rounding_bound(x, w1, w3, w2)) if dtype == torch.bfloat16 else None,
        kernel=lambda *a: expert_ffn_gemv(*a, backend="cuda"),
        plain=lambda *a: expert_ffn_gemv(*a, backend="ref"),
        library=library,
        held=(buf.numel() + x.numel()) * isz,
        bound=bound_ms(nbytes, 6.0 * n_live * t * d * f, dtype),
        calls=calls,
    )


def mla_case(dtype, *, b, c, past, dev, gen, nb=18):
    """Absorbed MLA at deepseek-v2's widths (H=128, r=512, rd=64, scale
    192^-0.5) over 4-token blocks, `nb` per row (18: cache_len 72, as
    served): fp32 queries, latent pools in `dtype`. The math is fp32 on
    both sides in either pool dtype, so both are held to the fp32
    tolerance (bf16 pools: q in three bf16 terms, all of its 24 bits, P
    in two, 16 bits; each product with a latent exact in fp32). Library: SDPA over [q_lat | q_rope] against
    [ckv | krope] broadcast to the heads, values ckv, with the position
    mask. Bound: bytes, or the fp32-exact operations (bf16: twice the
    fp32 count, the least split the tensor cores need, at 989 TFLOP/s;
    fp32: at 67). A table of enough key tiles to split over is also
    timed with one split (`unsplit`)."""
    h, r, rd, bs = 128, 512, 64, 4
    scale = (128 + 64) ** -0.5
    n_blocks = 8 * nb
    perm = torch.randperm(n_blocks, generator=gen, device="cpu")[: b * nb]
    tables = perm.reshape(b, nb).to(torch.int32).to(dev)
    q_lat = torch.randn(b, c, h, r, generator=gen).to(dev)
    q_rope = torch.randn(b, c, h, rd, generator=gen).to(dev)
    pool_ckv = torch.randn(n_blocks + 1, bs, r, generator=gen).to(dev, dtype)
    pool_krope = torch.randn(n_blocks + 1, bs, rd, generator=gen).to(dev, dtype)
    past_len = torch.tensor(past, dtype=torch.int32, device=dev)
    lengths = torch.full((b,), c, dtype=torch.int32, device=dev)
    args = (q_lat, q_rope, pool_ckv, pool_krope, tables, past_len, lengths)
    ckv = linearize_blocks(pool_ckv, tables).float()  # [B, S, r]
    keys = torch.cat([ckv, linearize_blocks(pool_krope, tables).float()], -1)
    qh = torch.cat([q_lat, q_rope], -1).transpose(1, 2)  # [B, H, C, r + rd]
    n_keys = keys.shape[1]
    kh = keys[:, None].expand(b, h, n_keys, r + rd)  # one latent stream, all heads
    vh = ckv[:, None].expand(b, h, n_keys, r)
    qpos = past_len[:, None] + torch.arange(c, device=dev)[None, :]
    mask = (torch.arange(n_keys, device=dev)[None, None, :] <= qpos[:, :, None])[:, None]
    # least work: walked latents read once per row, q read, o_lat written
    walked = sum(min(nb, (p + c - 1) // bs + 1) * bs for p in past)
    nbytes = ((2 * q_lat.numel() + q_rope.numel()) * 4
              + walked * (r + rd) * pool_ckv.element_size() + tables.numel() * 4)
    visible = sum(sum(p + i + 1 for i in range(c)) for p in past)
    flops = 2.0 * visible * h * (2 * r + rd)
    bf16 = dtype == torch.bfloat16
    return dict(
        args=args, lib_args=(qh, kh, vh, mask),
        kernel=lambda *a: paged_prefill_mla(*a, scale=scale, backend="cuda"),
        plain=lambda *a: paged_prefill_mla(*a, scale=scale, backend="ref"),
        library=lambda q, k, v, m: F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                                                  scale=scale),
        held=sum(t.numel() * t.element_size() for t in args),
        bound=bound_ms(nbytes, 2 * flops, dtype) if bf16 else bound_ms(nbytes, flops, dtype),
        tol=TOL[torch.float32],
        variants={"unsplit": lambda *a: mla_launch(*a, scale, splits=1)}
        if bf16 and nb >= 256 else {},
    )


def flash_case(dtype, *, b, s, h, dh, dev, gen):
    """Causal dense attention in the kernel layout [B*H, S, dh]. Library:
    SDPA(is_causal=True) in [B, H, S, dh]. The largest case cuts the
    graph to a few calls: its plain version materializes the S x S
    scores. bf16 is held to `rounding_bound`, which scales with each
    output (a fixed 3e-2 is as large as a late row's output at S=8192)."""
    q, k, v = (torch.randn(b * h, s, dh, generator=gen).to(dev, dtype) for _ in range(3))
    isz = q.element_size()
    return dict(
        args=(q, k, v), lib_args=tuple(t.reshape(b, h, s, dh) for t in (q, k, v)),
        kernel=lambda *a: flash_attention(*a, causal=True, backend="cuda"),
        plain=lambda *a: flash_attention(*a, causal=True, backend="ref"),
        library=lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        held=3 * q.numel() * isz,
        bound=bound_ms(4 * q.numel() * isz, 4.0 * dh * b * h * s * (s + 1) / 2, dtype),
        calls=2 if s > 2048 else 32,
        tol=(lambda: rounding_bound(q[None], k[None], v[None], causal=True)[0])
        if dtype == torch.bfloat16 else TOL[torch.float32],
    )


KERNEL_CASES = [  # (kernel, label, case, kwargs); the first per kernel is its JSON row
    ("paged_prefill_gqa", "decode B=4 nb=16", attention_case,
     dict(b=4, c=1, nb=16, past=[40, 51, 60, 63])),
    ("paged_prefill_gqa", "prefill B=4 C=32 nb=16", attention_case,
     dict(b=4, c=32, nb=16, past=[0, 16, 16, 24])),
    # decode over a long cache (4096 keys, 64 key tiles): the key splits
    # (and their combine) against one split; then the same table width
    # with short rows, where most splits find no key tile to walk
    ("paged_prefill_gqa", "decode B=4 nb=1024 long rows", attention_case,
     dict(b=4, c=1, nb=1024, past=[3900, 4000, 4050, 4095])),
    ("paged_prefill_gqa", "decode B=4 nb=1024 short rows", attention_case,
     dict(b=4, c=1, nb=1024, past=[40, 51, 60, 63])),
    ("moe_gemm", "gate|up hot 8x128x1024x1024", moe_gemm_case,
     dict(n_slots=8, rows=128, d=1024, f=512, pair=True)),
    ("moe_gemm", "down hot 8x128x512x1024", moe_gemm_case,
     dict(n_slots=8, rows=128, d=1024, f=512, pair=False)),
    # deepseek-v2-236b's hot tier at a prefill chunk (25 slots, d_model
    # 5120, d_expert 1536): one input set is ~1.2 GB, so 8 calls a graph
    ("moe_gemm", "deepseek gate|up hot 25x128x5120x3072", moe_gemm_case,
     dict(n_slots=25, rows=128, d=5120, f=1536, pair=True, calls=8)),
    ("moe_gemm", "deepseek down hot 25x128x1536x5120", moe_gemm_case,
     dict(n_slots=25, rows=128, d=5120, f=1536, pair=False, calls=8)),
    ("expert_ffn_gemv", "cold 16 slots T=8", gemv_case, dict(n_slots=16, t=8)),
    ("expert_ffn_gemv", "hot 8 slots T=4", gemv_case, dict(n_slots=8, t=4)),
    # deepseek-v2-236b's decode tiers (d_model 5120, d_expert 1536): the
    # hot tier with every slot live (the dense rate), and the warm tier
    # with 8 of 48 slots live (the bound counts those 8); 8 calls a graph
    ("expert_ffn_gemv", "deepseek hot 25 slots T=4", gemv_case,
     dict(n_slots=25, t=4, d=5120, f=1536, calls=8)),
    ("expert_ffn_gemv", "deepseek warm 48 slots T=4, 8 live", gemv_case,
     dict(n_slots=48, t=4, d=5120, f=1536, live=8, calls=8)),
    # a decode group of 40 rows at granite's widths: two token groups
    ("expert_ffn_gemv", "cold 16 slots T=40", gemv_case, dict(n_slots=16, t=40)),
    ("paged_prefill_mla", "decode B=4 H=128 r=512 nb=18", mla_case,
     dict(b=4, c=1, past=[40, 51, 60, 71])),
    ("paged_prefill_mla", "prefill B=4 C=32 H=128 r=512 nb=18", mla_case,
     dict(b=4, c=32, past=[0, 16, 24, 40])),
    # decode over a long cache (4096 keys, 64 key tiles): the key splits
    # (and their combine) against one split
    ("paged_prefill_mla", "decode B=4 H=128 r=512 nb=1024", mla_case,
     dict(b=4, c=1, past=[3900, 4000, 4050, 4095], nb=1024)),
    ("flash_attention", "mha B=1 S=512 H=4 dh=64 causal", flash_case,
     dict(b=1, s=512, h=4, dh=64)),
    ("flash_attention", "llama3.2-3b H=24 dh=128 S=8192 causal", flash_case,
     dict(b=1, s=8192, h=24, dh=128)),
]


def run_case(name, label, make, dtype, kw, dev, gen) -> dict:
    """Hold the kernel against its plain version on one input set, then
    time kernel, plain version and library call on the device (CUDA-graph
    replay over enough input sets to exceed L2), and the kernel's eager
    call with its host cost."""
    first = make(dtype, dev=dev, gen=gen, **kw)
    n_sets = max(1, min(MAX_SETS, math.ceil(2 * L2_BYTES / first["held"])))
    sets = [first] + [make(dtype, dev=dev, gen=gen, **kw) for _ in range(n_sets - 1)]
    got = first["kernel"](*first["args"])
    want = first["plain"](*first["args"])
    tol = first.get("tol")
    tol = tol() if callable(tol) else tol
    torch.cuda.synchronize()
    max_abs, max_rel, err_over_tol = compare(f"{name}/{label}", got, want, dtype, tol)
    variants = first.get("variants", {})
    for vname, fn in variants.items():  # held to the same tolerance
        compare(f"{name}/{label}/{vname}", fn(*first["args"]), want, dtype, tol)
    del got, want, tol
    args = [s["args"] for s in sets]
    b_ms, b_by = first["bound"]
    calls = first.get("calls", 32)
    extra = {f"{vname}_ms": device_time_ms(fn, args, calls=calls)
             for vname, fn in variants.items()}
    return dict(
        phase="kernel", kernel=name, case=label, dtype=str(dtype)[6:],
        kernel_ms=device_time_ms(first["kernel"], args, calls=calls),
        kernel_call_ms=call_time_ms(lambda: first["kernel"](*first["args"]),
                                    50 if calls == 32 else 3),
        plain_ms=device_time_ms(first["plain"], args, calls=calls),
        library_ms=device_time_ms(first["library"], [s["lib_args"] for s in sets],
                                  calls=calls),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=max_abs, max_rel_err=max_rel,
        err_over_tol=err_over_tol, input_sets=n_sets, **extra,
    )


def kernel_phases(dev) -> dict:
    gen = torch.Generator().manual_seed(0)
    rows = {}
    for name, label, make, kw in KERNEL_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            line = run_case(name, label, make, dtype, kw, dev, gen)
            print(json.dumps(line), flush=True)
            if dtype == torch.bfloat16 and name not in rows:
                rows[name] = line
    return rows


# ------------------------------------------------------------- serving
def make_traffic(vocab: int, n: int, seed: int, new_tokens: int = 16):
    """n requests: a shared 16-token system prompt plus 8-40 random tokens."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, 16)
    return [
        Request(rid=rid, prompt=np.concatenate(
            [system, rng.integers(0, vocab, int(rng.integers(8, 41)))]).astype(np.int32),
            max_new_tokens=new_tokens)
        for rid in range(n)
    ]


def reset_counters() -> None:
    for fn, *_ in KERNELS.values():
        fn.launches = 0


def read_counters() -> dict:
    return {name: fn.launches for name, (fn, *_) in KERNELS.items()}


def mha_entry(dev) -> dict:
    """Flash attention's own path: its entry point `mha` (the kernel
    bench's shape, bf16, causal) with the counters reset just before.
    Checked against the plain version, within `rounding_bound`, after
    the counters are read."""
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(1, 512, 4, 64, generator=gen).to(dev, torch.bfloat16)
               for _ in range(3))
    reset_counters()
    out = mha(q, k, v, causal=True)
    torch.cuda.synchronize()
    launches = read_counters()
    if launches["flash_attention"] == 0:
        fail("mha did not launch the flash_attention kernel")
    bound = rounding_bound(*(t.transpose(1, 2) for t in (q, k, v)), causal=True)
    max_abs, _, err_over_tol = compare("mha", out, mha(q, k, v, causal=True, backend="ref"),
                                       torch.bfloat16, bound.transpose(1, 2))
    line = dict(phase="mha", path=MHA_PATH, shape=list(q.shape), launches=launches,
                max_abs_err=max_abs, err_over_tol=err_over_tol)
    print(json.dumps(line), flush=True)
    return line


def serve_full(dev, arch: str, n_layers, expect, forbid, profile_out=None) -> dict:
    """Serve `arch` at its published widths (depth cut to `n_layers`
    where given) through ServingLoop; the kernels in `expect` must launch
    and those in `forbid` must not."""
    cfg = get_config(arch)
    if n_layers is not None:
        print(f"{arch}: depth cut {cfg.n_layers} -> {n_layers} layers, every width as "
              f"published", flush=True)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats(dev)  # peak_mem_gb: this phase only
    t0 = time.time()
    params = init_params(0, cfg, device=dev)
    loop = ServingLoop(cfg, params, batch_size=8, n_groups=2, cache_len=72,
                       block_size=4, prefill_chunk_tokens=32, device=dev)
    del params  # the engine keeps the stripped params, the tiers the experts
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    setup_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    # warm-up (cuBLAS handles, allocator) on prompts sharing nothing with
    # the measured traffic; then every metric and counter starts at 0
    for r in make_traffic(cfg.vocab_size, 2, seed=99, new_tokens=4):
        loop.submit(r)
    loop.run()
    loop.obs.registry.reset()
    loop.kv.stats = PagedStats()
    reqs = make_traffic(cfg.vocab_size, 12, seed=1)
    n_before = len(loop.completions)
    reset_counters()
    for r in reqs:
        loop.submit(r)
    done = loop.run()[n_before:]
    launches = read_counters()
    if len(done) != len(reqs) or any(len(r.generated) != 16 for r in done):
        fail(f"{arch}: served {len(done)}/{len(reqs)} requests completely")
    toks = np.concatenate([np.asarray(r.generated) for r in done])
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"{arch}: generated token ids outside the vocabulary")
    for name in expect:
        if launches[name] == 0:
            fail(f"{arch}: kernel {name} was never launched on the serving path")
    for name in forbid:
        if launches[name] != 0:
            fail(f"{arch}: kernel {name} launched {launches[name]} times off its path")
    st, eng = loop.stats, loop.engine
    out = dict(
        phase="serve", path=arch, arch=arch, dtype=cfg.param_dtype, layers=cfg.n_layers,
        d_model=cfg.d_model, requests=len(done), generated_tokens=st.generated_tokens,
        wall_s=st.wall_s, tokens_per_s=st.tokens_per_s, ttft_p50_s=st.ttft_p50_s,
        itl_p50_s=st.itl_p50_s, itl_p95_s=st.itl_p95_s, decode_steps=st.decode_steps,
        prefill_chunks=st.prefill_chunks, replans=st.replans, migrations=st.migrations,
        prefix_hit_rate=loop.kv.stats.hit_rate, tier_sizes=list(eng.sizes),
        setup_s=setup_s, setup_peak_mem_gb=setup_peak_gb,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9, launches=launches,
    )
    print(json.dumps(out), flush=True)
    if profile_out:
        p = Path(profile_out)
        profile_serving(loop, cfg, p.with_name(f"{p.stem}-{arch}{p.suffix}"))
    return out


def profile_serving(loop, cfg, out: Path) -> None:
    """torch.profiler window over a second wave of traffic: device time
    by kernel name (the full table is written to `out`)."""
    from torch.profiler import ProfilerActivity, profile

    reqs = make_traffic(cfg.vocab_size, 8, seed=2)
    for r in reqs:
        loop.submit(r)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        loop.run()
        wall = time.time() - t0
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(table)
    dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    print(json.dumps(dict(phase="profile", arch=cfg.name, wall_s=wall, device_busy_s=dev_us / 1e6,
                          device_busy_share=dev_us / 1e6 / wall)), flush=True)
    print(table[:6000], flush=True)


def serve_smoke_parity(dev, arch: str) -> None:
    """fp32 smoke `arch`: the kernels on the card against the plain
    versions on the CPU, same weights and tier state -> same tokens."""
    cfg = reduce_for_smoke(get_config(arch))
    cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    params = init_params(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    tiered = fill_tiers_from_params(params, init_tiered_for_model(gen, cfg), cfg)

    def to(tree, d):
        return {k: to(v, d) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(d)

    got = {}
    for d in (dev, torch.device("cpu")):
        loop = ServingLoop(cfg, to(params, d), to(tiered, d), batch_size=4, n_groups=2,
                           cache_len=64, prefill_chunk_tokens=8, device=d)
        for r in make_traffic(cfg.vocab_size, 6, seed=3, new_tokens=8):
            loop.submit(r)
        got[d.type] = {r.rid: r.generated for r in loop.run()}
    if got["cuda"] != got["cpu"]:
        fail(f"{arch} fp32 smoke serving: card tokens {got['cuda']} != CPU tokens "
             f"{got['cpu']}")
    print(json.dumps(dict(phase="smoke_parity", arch=arch, requests=len(got["cpu"]),
                          identical_tokens=True)), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also trace a serving window with torch.profiler")
    ap.add_argument("--profile-out", default="profile_out/serve_profile.txt",
                    help="where --profile writes its full tables (one per model: "
                         "the file name's stem gets -<arch>)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device: chip_smoke.py runs on the GPU", flush=True)
        return 1
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    build.build_all()
    print(json.dumps(dict(phase="build", seconds=time.time() - t0)), flush=True)
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{name}] {line.strip()}", flush=True)
    tool = build.cuobjdump()
    if tool is None:
        fail("no cuobjdump beside nvcc or in Triton: cannot read the kernels' SASS")
    mma = {name: build.count_mma(tool, name) for name in build.SOURCES}
    print(json.dumps(dict(phase="sass", mma=mma)), flush=True)
    for name, op in TENSOR_CORE_KERNELS.items():
        if mma[name][op] == 0:
            fail(f"{name}: no {op} (tensor-core) instruction in its SASS")

    rows = kernel_phases(dev)
    paths = [mha_entry(dev)]
    paths.append(serve_full(
        dev, GQA_ARCH, None, expect=("paged_prefill_gqa", "moe_gemm", "expert_ffn_gemv"),
        forbid=("paged_prefill_mla",), profile_out=args.profile_out if args.profile else None))
    gc.collect()
    torch.cuda.empty_cache()  # the granite loop's weights and tiers
    paths.append(serve_full(
        dev, MLA_ARCH, MLA_LAYERS, expect=("paged_prefill_mla", "moe_gemm", "expert_ffn_gemv"),
        forbid=("paged_prefill_gqa",), profile_out=args.profile_out if args.profile else None))
    gc.collect()
    torch.cuda.empty_cache()
    for arch in (GQA_ARCH, MLA_ARCH):
        serve_smoke_parity(dev, arch)

    by_path = {p["path"]: p["launches"] for p in paths}  # each after its own reset
    kernels = []
    for name, (fn, src, replaces, path) in KERNELS.items():
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=by_path[path][name],
            launches_by_path={p: n[name] for p, n in by_path.items()},
            max_abs_err=r["max_abs_err"], ms=r["kernel_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
