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
     shapes (a speculative verify chunk's included: rows shorter than the
     chunk, only their real tokens compared), in bf16 and fp32, and time
     kernel / plain / library on the device (CUDA-graph replay), plus the
     kernel's eager call;
  3. drive flash attention's entry point `mha` with the launch counters
     reset just before; time one jamba Mamba layer at published widths
     (its masked 64-token forward, the chunk scan alone, a decode step);
     run xlstm-125m at full width and depth (bf16 prefill and 16 decode
     steps through the contiguous and the paged model functions: equal
     tokens, no kernel launched; fp32 smoke logits on the card within
     1e-5 of the CPU's); hold the differentiable moe_gemm's output and
     gradients (the SwiGLU FFN of granite's training buffers, h [32, 1280,
     1024]) against the plain route's autograd and time its two dX
     products; train granite-moe-1b-a400m at full width and depth for 8
     steps of 8 x 512 (finite, falling loss; moe_gemm 6 launches a MoE
     layer a step and no other kernel), then generate from it without
     tiers (moe_gemm on the prefill, the GEMV on the decode steps); two
     fp32 smoke train steps on the card and the CPU (state within 1e-5,
     equal expert counts) and a checkpoint of the card's state restored
     on the CPU bitwise;
  4. serve granite-moe-1b-a400m (GQA) at full width and depth, then
     deepseek-v2-236b (MLA, dense layer 0, shared experts) at full width
     with its depth cut to 3 layers (bf16, seeded random weights),
     through ServingLoop with the kernel launch counters reset just
     before each, and check every request completed and every kernel of
     the path ran (and the kernels off the path did not). Each model is
     served in the default mode (paged KV, chunked prefill) and with
     whole-suffix admission prefill, each over the contiguous
     `kv_layout="slots"` cache and over paged KV with
     `chunked_prefill=False` (those modes must run no prefill chunk),
     and with speculative decode (`spec_decode=True`: a recorded wave,
     then its replay, which must accept drafts and verify chunks wider
     than 1; its bf16 token agreement with the default mode is reported),
     and granite at fp32, whose spec tokens must equal its plain tokens;
     then jamba-v0.1-52b (Mamba + GQA + MoE) at full width with its depth
     cut to 8 layers (one Jamba block), in its paged default (whole-suffix
     admission: a recurrent arch has no chunked prefill or radix) and over
     the slots cache, with spec_decode refused;
  5. serve each smoke-size model at fp32 on the card (kernels) and on the
     CPU (plain versions) from the same weights, in each of those modes:
     tokens must agree, and speculative serving (a wave and its replay)
     must give the default mode's tokens and accept drafts; replay a
     skewed, bursty request trace (`replay_requests`) on both: it must
     drain with equal tokens; and jamba's smoke config in its paged
     default and slots modes.
`--profile` also profiles 2 train steps. Prints one JSON line per phase
(each with its seconds), the `kernels` JSON line (moe_gemm's with its
train-step dX rows), the card's name and power limit, and last the `ok` JSON line.
Imports nothing of JAX: the machine with the card has none.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.expert_gemv import (  # noqa: E402
    cold_expert_ffn,
    expert_ffn_gemv,
    gemv_rounding_bound,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    mha,
    rounding_bound,
)
from repro_torch.checkpoint import restore, save  # noqa: E402
from repro_torch.data.pipeline import SyntheticCorpus  # noqa: E402
from repro_torch.kernels.moe_gemm import grouped_expert_ffn, moe_gemm  # noqa: E402
from repro_torch.kernels.moe_gemm.kernel import _launch as gemm_launch  # noqa: E402
from repro_torch.kernels.moe_gemm.ref import grad_rounding_bound, moe_gemm_ref  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    gqa_rounding_bound,
    linearize_blocks,
    paged_prefill_gqa,
    paged_prefill_mla,
)
from repro_torch.kernels.paged_attention.kernel import _launch as gqa_launch  # noqa: E402
from repro_torch.kernels.paged_attention.kernel import _launch_mla as mla_launch  # noqa: E402
from repro_torch.core.traces import synth_request_trace  # noqa: E402
from repro_torch.models.mamba import _assoc_scan, mamba_decode, mamba_forward  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    decode_step,
    decode_step_paged,
    forward_train,
    init_params,
    is_recurrent,
    prefill,
    prefill_paged,
)
from repro_torch.serving.batching import Request  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    fill_tiers_from_params,
    init_tiered_for_model,
)
from repro_torch.serving.loop import ServingLoop  # noqa: E402
from repro_torch.serving.paged_kv import PagedStats, init_paged_cache  # noqa: E402
from repro_torch.serving.replay import replay_requests  # noqa: E402
from repro_torch.serving.tiered_moe import TierSizes  # noqa: E402
from repro_torch.training import (  # noqa: E402
    AdamWConfig,
    adamw_init,
    init_train_state,
    make_train_step,
    value_and_grad,
)
from repro_torch.tree import leaves_with_path, tree_map  # noqa: E402

HBM_BPS = 3.35e12  # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32
GQA_ARCH = "granite-moe-1b-a400m"
MLA_ARCH = "deepseek-v2-236b"
MLA_LAYERS = 3  # deepseek depth cut 60 -> 3: dense layer 0 + 2 MoE layers
JAMBA_ARCH = "jamba-v0.1-52b"
# jamba depth cut 32 -> 8: one whole Jamba block (attention at layer 4,
# Mamba elsewhere, MoE at 1 / 3 / 5 / 7); 16 layers would not fit the card
JAMBA_LAYERS = 8
XLSTM_ARCH = "xlstm-125m"
# loop arguments by arch: jamba's tiers as explicit sizes (4 hot slots;
# the cold buffer pads to 16 slots: ~35 GB of tier buffers at 8 layers)
ARCH_LOOP_KW = {JAMBA_ARCH: dict(sizes=TierSizes(4, 5, 7))}
MHA_PATH = "mha"
TRAIN_PATH = "train"  # granite-moe-1b-a400m trained at full width and depth
GENERATE_PATH = "train/generate"  # then prefill + decode of the flat MoE model
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 512, 8
TRAIN_OPT = AdamWConfig(lr=1e-3, warmup_steps=2)
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
# fp32 expert GEMV: the same products as the plain version summed in
# another order, over at most a few thousand terms, as the card tests hold it
GEMV_F32_TOL = (1e-5, 1e-5)


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


def profiled_device_ms(fn, reps: int) -> float:
    """Mean device time of fn(): the profiler's kernel time over `reps`
    calls (for a function of many small launches, where a CUDA graph of
    it would time the same kernels without their gaps)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps


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


def _real(lens, c, dev):
    """Each row's real chunk tokens [B, C] (a verify chunk's rows have
    fewer than C); only these are compared and counted in the bound."""
    return torch.arange(c, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]


def attention_case(dtype, *, b, c, nb, past, dev, gen, lens=None, kv=8, g=2, hd=64):
    """Random pools and tables at the serving shapes: granite's Kv=8, G=2,
    hd=64 unless given (jamba: G=4, hd=128), bs=4, each row's blocks a
    random permutation of the pool; `lens` the rows' real chunk tokens
    (default all C). Library: SDPA over the linearized, head-expanded K/V
    with the position mask. bf16 is held to `gqa_rounding_bound`; a table
    of enough key tiles to split over is also timed with one split
    (`unsplit`)."""
    bs = 4
    n_blocks = max(8 * 18, b * nb)  # batch 8 x ceil(72 / 4) blocks per slot
    perm = torch.randperm(n_blocks, generator=gen, device="cpu")[: b * nb]
    tables = perm.reshape(b, nb).to(torch.int32).to(dev)
    q = torch.randn(b, c, kv, g, hd, generator=gen).to(dev, dtype)
    pool_k = torch.randn(n_blocks + 1, bs, kv, hd, generator=gen).to(dev, dtype)
    pool_v = torch.randn(n_blocks + 1, bs, kv, hd, generator=gen).to(dev, dtype)
    lens = lens or [c] * b
    past_len = torch.tensor(past, dtype=torch.int32, device=dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    args = (q, pool_k, pool_v, tables, past_len, lengths)
    keys = linearize_blocks(pool_k, tables).repeat_interleave(g, dim=2).transpose(1, 2)
    vals = linearize_blocks(pool_v, tables).repeat_interleave(g, dim=2).transpose(1, 2)
    qh = q.reshape(b, c, kv * g, hd).transpose(1, 2)
    qpos = past_len[:, None] + torch.arange(c, device=dev)[None, :]
    mask = (torch.arange(keys.shape[2], device=dev)[None, None, :] <= qpos[:, :, None])[:, None]
    # least work: each walked key block read once per row, the real
    # tokens' q read and out written
    isz = q.element_size()
    walked = sum(min(nb, (p + n - 1) // 4 + 1) * 4 for p, n in zip(past, lens))
    nbytes = 2 * sum(lens) * kv * g * hd * isz + 2 * walked * kv * hd * isz + tables.numel() * 4
    visible = sum(sum(p + i + 1 for i in range(n)) for p, n in zip(past, lens))
    bf16 = dtype == torch.bfloat16
    return dict(
        real=_real(lens, c, dev),
        args=args, lib_args=(qh, keys, vals, mask),
        kernel=lambda *a: paged_prefill_gqa(*a, backend="cuda"),
        plain=lambda *a: paged_prefill_gqa(*a, backend="ref"),
        library=lambda qh, k, v, m: F.scaled_dot_product_attention(qh, k, v, attn_mask=m),
        held=sum(t.numel() * t.element_size() for t in args),
        bound=bound_ms(nbytes, 4.0 * visible * kv * g * hd, dtype),
        tol=(lambda: gqa_rounding_bound(*args[:5])) if bf16 else None,
        variants={"unsplit": lambda *a: gqa_launch(*a, splits=1)} if bf16 and nb >= 256 else {},
    )


def moe_gemm_case(dtype, *, n_slots, rows, d, f, pair, dev, gen, calls=32, flat=False):
    """Hot tier of a prefill chunk: n_slots groups of `rows` real rows
    padded to 128, over a tier buffer [n_slots, 3, d, f]. gate|up
    (k = d, n = 2f) reads its two panels as one; down (k = f, n = d)
    reads the stored [d, f] matrix transposed. `flat`: the flat MoE's
    own parameters instead (its prefill and training forward), all
    experts as groups: gate|up over the [E, d, 2f] panel that
    `grouped_expert_ffn` joins from the separate [E, d, f] parameters by
    torch.cat, down over the row-major [E, f, d] parameter. Library:
    torch.bmm over the concatenated (or copied) weights."""
    bm = 128
    k, n = (d, 2 * f) if pair else (f, d)
    c_pad = -(-rows // bm) * bm
    buf = (torch.randn(n_slots, 3, d, f, generator=gen) * d ** -0.5).to(dev, dtype)
    x = torch.zeros(n_slots, c_pad, k, dtype=dtype, device=dev)
    x[:, :rows] = torch.randn(n_slots, rows, k, generator=gen).to(dev, dtype)
    x = x.reshape(n_slots * c_pad, k)
    if flat:
        w = torch.cat([buf[:, 0], buf[:, 1]], -1) if pair else buf[:, 2].transpose(1, 2)
        w = w.contiguous()
    else:
        w = (buf[:, 0], buf[:, 1]) if pair else buf[:, 2].transpose(1, 2)
    te = torch.arange(n_slots, dtype=torch.int32, device=dev).repeat_interleave(c_pad // bm)
    wj = torch.cat(list(w), -1) if pair and not flat else w.contiguous()
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


def gemv_case(dtype, *, n_slots, t, dev, gen, d=1024, f=512, live=None, calls=32,
              flat=False):
    """One tier of a decode step: n_slots experts, t tokens each, read as
    views of the [n, 3, D, F] tier buffer (down matrix transposed).
    `flat`: the flat MoE's decode step instead, all experts as slots over
    the model's own parameters, the row-major [E, F, D] w_down read in
    place, through `cold_expert_ffn` as the model calls it; in bf16 also
    timed as `copied`: w_down first copied into the tier layout, as the
    wrapper did before the down pass read the row-major layout. With
    `live`, only the first `live` slots have tokens and the others' rows
    are zero, as dispatch leaves a slot no token was routed to; the bound
    then counts only the live slots' weight bytes, which is all the work
    the function needs (an all-zero slot's output is exactly zero).
    Library: bmm of the concatenated gate|up, SiLU * up, bmm down. bf16
    is held to `gemv_rounding_bound`, fp32 to GEMV_F32_TOL."""
    buf = (torch.randn(n_slots, 3, d, f, generator=gen) * d ** -0.5).to(dev, dtype)
    x = torch.randn(n_slots, t, d, generator=gen).to(dev, dtype)
    n_live = n_slots if live is None else live
    x[n_live:] = 0
    w1, w3, w2 = buf[:, 0], buf[:, 1], buf[:, 2].transpose(1, 2)
    if flat:
        w2 = w2.contiguous()
    launch = cold_expert_ffn if flat else expert_ffn_gemv

    def library(x, w13, w2c):
        gu = torch.bmm(x, w13)
        return torch.bmm(F.silu(gu[..., :f]) * gu[..., f:], w2c)

    isz = x.element_size()
    nbytes = (3 * n_live * d * f + 2 * n_live * t * d) * isz
    return dict(
        args=(x, w1, w3, w2), lib_args=(x, torch.cat([w1, w3], -1), w2.contiguous()),
        tol=(lambda: gemv_rounding_bound(x, w1, w3, w2)) if dtype == torch.bfloat16
        else GEMV_F32_TOL,
        kernel=lambda *a: launch(*a, backend="cuda"),
        plain=lambda *a: expert_ffn_gemv(*a, backend="ref"),
        library=library,
        held=(buf.numel() + x.numel()) * isz,
        bound=bound_ms(nbytes, 6.0 * n_live * t * d * f, dtype),
        calls=calls,
        variants={"copied": lambda x, w1, w3, w2: expert_ffn_gemv(
            x, w1, w3, w2.transpose(1, 2).contiguous().transpose(1, 2), backend="cuda")}
        if flat and dtype == torch.bfloat16 else {},
    )


def mla_case(dtype, *, b, c, past, dev, gen, nb=18, lens=None):
    """Absorbed MLA at deepseek-v2's widths (H=128, r=512, rd=64, scale
    192^-0.5) over 4-token blocks, `nb` per row (18: cache_len 72, as
    served): fp32 queries, latent pools in `dtype`. The math is fp32 on
    both sides in either pool dtype, so both are held to the fp32
    tolerance (bf16 pools: q in three bf16 terms, all of its 24 bits, P
    in two, 16 bits; each product with a latent exact in fp32). Library: SDPA over [q_lat | q_rope] against
    [ckv | krope] broadcast to the heads, values ckv, with the position
    mask. Bound: bytes, or the fp32-exact operations (bf16: twice the
    fp32 count, the least split the tensor cores need, at 989 TFLOP/s;
    fp32: at 67). `lens`: the rows' real chunk tokens, as in
    `attention_case`. A table of enough key tiles to split over is also
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
    lens = lens or [c] * b
    past_len = torch.tensor(past, dtype=torch.int32, device=dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    args = (q_lat, q_rope, pool_ckv, pool_krope, tables, past_len, lengths)
    ckv = linearize_blocks(pool_ckv, tables).float()  # [B, S, r]
    keys = torch.cat([ckv, linearize_blocks(pool_krope, tables).float()], -1)
    qh = torch.cat([q_lat, q_rope], -1).transpose(1, 2)  # [B, H, C, r + rd]
    n_keys = keys.shape[1]
    kh = keys[:, None].expand(b, h, n_keys, r + rd)  # one latent stream, all heads
    vh = ckv[:, None].expand(b, h, n_keys, r)
    qpos = past_len[:, None] + torch.arange(c, device=dev)[None, :]
    mask = (torch.arange(n_keys, device=dev)[None, None, :] <= qpos[:, :, None])[:, None]
    # least work: walked latents read once per row, the real tokens' q
    # read and o_lat written
    walked = sum(min(nb, (p + n - 1) // bs + 1) * bs for p, n in zip(past, lens))
    nbytes = (sum(lens) * h * (2 * r + rd) * 4
              + walked * (r + rd) * pool_ckv.element_size() + tables.numel() * 4)
    visible = sum(sum(p + i + 1 for i in range(n)) for p, n in zip(past, lens))
    flops = 2.0 * visible * h * (2 * r + rd)
    bf16 = dtype == torch.bfloat16
    return dict(
        real=_real(lens, c, dev),
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
    # whole-suffix admission (chunked_prefill=False): a 64-token bucket of
    # the table powers_of_two(72) over the served 18-block tables, rows
    # with and without a 16-token cached prefix; 128 query rows (G=2), two
    # row tiles
    ("paged_prefill_gqa", "prefill B=4 C=64 nb=18", attention_case,
     dict(b=4, c=64, nb=18, past=[0, 16, 0, 16])),
    # decode over a long cache (4096 keys, 64 key tiles): the key splits
    # (and their combine) against one split; then the same table width
    # with short rows, where most splits find no key tile to walk
    # a speculative verify chunk at the default k = 4 (the sampled token
    # and up to 4 drafts, padded to a width of 8): rows of 5, 1, 3 and 8
    # real tokens after pasts that are not block-aligned
    ("paged_prefill_gqa", "verify B=4 C=8 nb=18", attention_case,
     dict(b=4, c=8, nb=18, past=[41, 50, 63, 27], lens=[5, 1, 3, 8])),
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
    # 16 tokens a slot at deepseek's widths: the fp32 kernel stages 10 at
    # a time there (two token groups)
    ("expert_ffn_gemv", "deepseek hot 25 slots T=16", gemv_case,
     dict(n_slots=25, t=16, d=5120, f=1536, calls=8)),
    # jamba-v0.1-52b's attention layer (32 heads, 8 KV heads, hd 128): a
    # decode step of one group over its 18-block tables, and the 64-token
    # whole-suffix bucket (no prefix reuse for a recurrent arch: past 0)
    ("paged_prefill_gqa", "jamba decode B=4 G=4 hd=128 nb=18", attention_case,
     dict(b=4, c=1, nb=18, past=[40, 51, 60, 71], g=4, hd=128)),
    ("paged_prefill_gqa", "jamba prefill B=4 C=64 G=4 hd=128 nb=18", attention_case,
     dict(b=4, c=64, nb=18, past=[0, 0, 0, 0], g=4, hd=128)),
    # jamba's tiers (d_model 4096, d_expert 14336, TierSizes(4, 5, 7)): a
    # decode step's hot tier with every slot live and warm tier with 2 of
    # 5 live; a prefill call's hot tier through the grouped GEMM (gate|up
    # N = 28672, down K = 14336); one input set is ~1.4-1.8 GB: 8 calls a graph
    ("expert_ffn_gemv", "jamba hot 4 slots T=4", gemv_case,
     dict(n_slots=4, t=4, d=4096, f=14336, calls=8)),
    ("expert_ffn_gemv", "jamba warm 5 slots T=4, 2 live", gemv_case,
     dict(n_slots=5, t=4, d=4096, f=14336, live=2, calls=8)),
    ("moe_gemm", "jamba gate|up hot 4x128x4096x28672", moe_gemm_case,
     dict(n_slots=4, rows=128, d=4096, f=14336, pair=True, calls=8)),
    ("moe_gemm", "jamba down hot 4x128x14336x4096", moe_gemm_case,
     dict(n_slots=4, rows=128, d=4096, f=14336, pair=False, calls=8)),
    # the train phase's generate through granite's flat MoE (no tiers):
    # its prefill runs all 32 experts as groups of 128 rows over the
    # model's parameters (gate|up joined by torch.cat, down row-major),
    # its decode steps the GEMV over all 32 experts as slots of cap = B = 4
    # tokens, every slot live here, w_down read row-major in place
    ("moe_gemm", "flat gate|up 32x128x1024x1024 joined", moe_gemm_case,
     dict(n_slots=32, rows=128, d=1024, f=512, pair=True, flat=True)),
    ("moe_gemm", "flat down 32x128x512x1024 row-major", moe_gemm_case,
     dict(n_slots=32, rows=128, d=1024, f=512, pair=False, flat=True)),
    ("expert_ffn_gemv", "flat decode 32 slots T=4 row-major W2", gemv_case,
     dict(n_slots=32, t=4, flat=True)),
    ("paged_prefill_mla", "decode B=4 H=128 r=512 nb=18", mla_case,
     dict(b=4, c=1, past=[40, 51, 60, 71])),
    ("paged_prefill_mla", "prefill B=4 C=32 H=128 r=512 nb=18", mla_case,
     dict(b=4, c=32, past=[0, 16, 24, 40])),
    # whole-suffix admission (chunked_prefill=False): a 64-token bucket
    ("paged_prefill_mla", "prefill B=4 C=64 H=128 r=512 nb=18", mla_case,
     dict(b=4, c=64, past=[0, 16, 0, 16])),
    # a speculative verify chunk, as the GQA case
    ("paged_prefill_mla", "verify B=4 C=8 H=128 r=512 nb=18", mla_case,
     dict(b=4, c=8, past=[41, 50, 63, 27], lens=[5, 1, 3, 8])),
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
    t0 = time.time()
    first = make(dtype, dev=dev, gen=gen, **kw)
    n_sets = max(1, min(MAX_SETS, math.ceil(2 * L2_BYTES / first["held"])))
    sets = [first] + [make(dtype, dev=dev, gen=gen, **kw) for _ in range(n_sets - 1)]
    got = first["kernel"](*first["args"])
    want = first["plain"](*first["args"])
    tol = first.get("tol")
    tol = tol() if callable(tol) else tol
    real = first.get("real")
    if real is not None:  # pad tokens' outputs are unspecified
        got, want = got[real], want[real]
        tol = tol[real] if isinstance(tol, torch.Tensor) else tol
    torch.cuda.synchronize()
    max_abs, max_rel, err_over_tol = compare(f"{name}/{label}", got, want, dtype, tol)
    variants = first.get("variants", {})
    for vname, fn in variants.items():  # held to the same tolerance
        out = fn(*first["args"])
        compare(f"{name}/{label}/{vname}", out if real is None else out[real], want, dtype,
                tol)
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
        err_over_tol=err_over_tol, input_sets=n_sets, **extra, seconds=time.time() - t0,
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
    t0 = time.time()
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
                max_abs_err=max_abs, err_over_tol=err_over_tol, seconds=time.time() - t0)
    print(json.dumps(line), flush=True)
    return line


# serving modes beside the default (paged KV, chunked prefill): loop kwargs
MODES = {"slots": dict(kv_layout="slots"), "nochunk": dict(chunked_prefill=False),
         "spec": dict(spec_decode=True)}
WHOLE_SUFFIX = ("slots", "nochunk")  # modes that admit with no prefill chunk
# (arch, depth cut, mode, kernels that must launch, kernels that must not)
SERVES = [
    (GQA_ARCH, None, None, ("paged_prefill_gqa", "moe_gemm", "expert_ffn_gemv"),
     ("paged_prefill_mla",)),
    (MLA_ARCH, MLA_LAYERS, None, ("paged_prefill_mla", "moe_gemm", "expert_ffn_gemv"),
     ("paged_prefill_gqa",)),
    (GQA_ARCH, None, "slots", ("moe_gemm", "expert_ffn_gemv"),
     ("paged_prefill_gqa", "paged_prefill_mla")),
    (GQA_ARCH, None, "nochunk", ("paged_prefill_gqa", "moe_gemm", "expert_ffn_gemv"),
     ("paged_prefill_mla",)),
    (MLA_ARCH, MLA_LAYERS, "nochunk", ("paged_prefill_mla", "moe_gemm", "expert_ffn_gemv"),
     ("paged_prefill_gqa",)),
    (MLA_ARCH, MLA_LAYERS, "slots", ("moe_gemm", "expert_ffn_gemv"),
     ("paged_prefill_mla", "paged_prefill_gqa")),
    (GQA_ARCH, None, "spec", ("paged_prefill_gqa", "moe_gemm", "expert_ffn_gemv"),
     ("paged_prefill_mla",)),
    (MLA_ARCH, MLA_LAYERS, "spec", ("paged_prefill_mla", "moe_gemm", "expert_ffn_gemv"),
     ("paged_prefill_gqa",)),
    # jamba: Mamba + GQA + MoE; its default paged mode admits whole
    # suffixes (a recurrent arch turns chunked prefill and the radix off)
    (JAMBA_ARCH, JAMBA_LAYERS, None, ("paged_prefill_gqa", "moe_gemm", "expert_ffn_gemv"),
     ("paged_prefill_mla", "flash_attention")),
    (JAMBA_ARCH, JAMBA_LAYERS, "slots", ("moe_gemm", "expert_ffn_gemv"),
     ("paged_prefill_gqa", "paged_prefill_mla", "flash_attention")),
]


def serve_wave(loop, reqs) -> list:
    """Submit `reqs`, run the loop to the end; this wave's completions in
    submission order."""
    n_before = len(loop.completions)
    for r in reqs:
        loop.submit(r)
    by_rid = {r.rid: r for r in loop.run()[n_before:]}
    return [by_rid[r.rid] for r in reqs if r.rid in by_rid]


def replayed(reqs, rid_base: int) -> list:
    """The same prompts and budgets under fresh rids: a replayed wave."""
    return [Request(rid=rid_base + i, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
            for i, r in enumerate(reqs)]


def serve_full(dev, arch: str, n_layers, mode, expect, forbid, profile_out=None,
               plain_tokens=None) -> dict:
    """Serve `arch` at its published widths (depth cut to `n_layers`
    where given) through ServingLoop in `mode` (None: the defaults; else
    a key of MODES; the whole-suffix modes must run no prefill chunk);
    the kernels in `expect` must launch and those in `forbid` must not.
    In spec mode the measured requests are first served once, which
    indexes their continuations in the radix tree as their slots free;
    the measured wave then replays the same prompts (fresh rids), as the
    reference's `serving_bench --spec` does, and must accept drafts and
    verify a chunk wider than 1. Its tokens are compared with
    `plain_tokens` (the default mode's, same weights and prompts): at
    bf16 they may differ, so the agreement is reported, not held."""
    t_phase = time.time()
    path = arch if mode is None else f"{arch}/{mode}"
    cfg = get_config(arch)
    if n_layers is not None:
        print(f"{arch}: depth cut {cfg.n_layers} -> {n_layers} layers, every width as "
              f"published", flush=True)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats(dev)  # peak_mem_gb: this phase only
    t0 = time.time()
    params = init_params(0, cfg, device=dev)
    kw = dict(batch_size=8, n_groups=2, cache_len=72, block_size=4, prefill_chunk_tokens=32,
              device=dev, **ARCH_LOOP_KW.get(arch, {}))
    loop = ServingLoop(cfg, params, **kw, **MODES.get(mode, {}))
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
    if loop.paged:
        loop.kv.stats = PagedStats()
    reqs = make_traffic(cfg.vocab_size, 12, seed=1)
    recorded = None
    # distinct experts each decode step's MoE layers touch (the loop
    # observes every step's counts once): the GEMV streams those slots
    # only, so their weight bytes bound the step's MoE time from below
    moe_rows = [i for i in range(cfg.n_layers) if cfg.uses_moe_layer(i)]
    touched, observe = [], loop.engine.observe
    loop.engine.observe = lambda c: (touched.append(int((np.asarray(c)[moe_rows] > 0).sum())),
                                     observe(c))
    if mode == "spec":  # the recorded wave; then every metric starts at 0 again
        recorded = [list(r.generated) for r in serve_wave(loop, reqs)]
        loop.obs.registry.reset()
        loop.kv.stats = PagedStats()
        loop.engine.verify_widths.clear()
        reqs = replayed(reqs, 100)
    reset_counters()
    touched.clear()
    done = serve_wave(loop, reqs)
    launches = read_counters()
    del loop.engine.observe  # the engine's own method again
    if len(done) != len(reqs) or any(len(r.generated) != 16 for r in done):
        fail(f"{arch}: served {len(done)}/{len(reqs)} requests completely")
    toks = np.concatenate([np.asarray(r.generated) for r in done])
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"{arch}: generated token ids outside the vocabulary")
    for name in expect:
        if launches[name] == 0:
            fail(f"{path}: kernel {name} was never launched on the serving path")
    for name in forbid:
        if launches[name] != 0:
            fail(f"{path}: kernel {name} launched {launches[name]} times off its path")
    st, eng = loop.stats, loop.engine
    if (mode in WHOLE_SUFFIX or is_recurrent(cfg)) and (loop.chunked or st.prefill_chunks):
        fail(f"{path}: {st.prefill_chunks} prefill chunks in a whole-suffix admission mode")
    extra = {}
    if is_recurrent(cfg) and mode is None:
        # speculative decode refuses a recurrent arch (the reference's
        # assertion), checked on the served weights and tiers
        try:
            ServingLoop(cfg, eng.params, eng.tiered, spec_decode=True, **kw)
        except AssertionError:
            extra["spec_decode_refused"] = True
        else:
            fail(f"{path}: spec_decode=True was accepted on a recurrent arch")
    if mode == "spec":
        extra = dict(spec_steps=st.spec_steps, spec_drafted_tokens=st.spec_drafted_tokens,
                     spec_accepted_tokens=st.spec_accepted_tokens,
                     spec_acceptance_rate=st.spec_acceptance_rate,
                     verify_widths=sorted(eng.verify_widths))
        if st.spec_accepted_tokens == 0:
            fail(f"{path}: the replayed wave accepted no draft token")
        if max(eng.verify_widths) <= 1:
            fail(f"{path}: no verify chunk was wider than 1")
        # bf16 agreement, reported: with the recorded wave (what the radix
        # drafts from) and with the default mode's tokens
        for name, ref in (("recorded", recorded), ("default", plain_tokens)):
            if ref is not None:
                extra[f"tokens_equal_to_{name}"] = sum(
                    a == b for r, p in zip(done, ref) for a, b in zip(r.generated, p))
                extra[f"first_tokens_equal_to_{name}"] = sum(
                    r.generated[0] == p[0] for r, p in zip(done, ref))
    out = dict(
        phase="serve", path=path, arch=arch, mode=mode or "default", dtype=cfg.param_dtype,
        layers=cfg.n_layers,
        d_model=cfg.d_model, requests=len(done), generated_tokens=st.generated_tokens,
        wall_s=st.wall_s, tokens_per_s=st.tokens_per_s, ttft_p50_s=st.ttft_p50_s,
        itl_p50_s=st.itl_p50_s, itl_p95_s=st.itl_p95_s, decode_steps=st.decode_steps,
        prefill_chunks=st.prefill_chunks, replans=st.replans, migrations=st.migrations,
        prefill_rows=eng.stats.prefills,
        prefix_hit_rate=loop.kv.stats.hit_rate if loop.paged else None,
        tier_sizes=list(eng.sizes), experts_per_step=float(np.mean(touched)),
        expert_bound_ms_per_step=float(np.mean(touched)) * 3 * cfg.d_model
        * cfg.moe.d_expert * 2 / HBM_BPS * 1e3,
        setup_s=setup_s, setup_peak_mem_gb=setup_peak_gb,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9, launches=launches, **extra,
        seconds=time.time() - t_phase,
    )
    print(json.dumps(out), flush=True)
    out["tokens"] = [list(r.generated) for r in done]
    if profile_out:
        p = Path(profile_out)
        name = path.replace("/", "-")
        profile_serving(loop, cfg, path, p.with_name(f"{p.stem}-{name}{p.suffix}"))
    return out


def spec_fp32_full(dev) -> None:
    """granite-moe-1b-a400m at full width and depth in fp32: the measured
    requests served plainly, then speculatively (recorded, then replayed
    under fresh rids). At fp32 a verify chunk's rounding does not flip a
    greedy token, so both spec waves must give the plain tokens and the
    replay must accept drafts: the wide verify path holds at full width,
    where the bf16 spec path's agreement is only reported."""
    t0 = time.time()
    cfg = dataclasses.replace(get_config(GQA_ARCH), param_dtype="float32",
                              compute_dtype="float32")
    params = init_params(0, cfg, device=dev)
    kw = dict(batch_size=8, n_groups=2, cache_len=72, block_size=4, prefill_chunk_tokens=32,
              device=dev)
    plain = [r.generated for r in serve_wave(ServingLoop(cfg, params, **kw),
                                             make_traffic(cfg.vocab_size, 12, seed=1))]
    loop = ServingLoop(cfg, params, spec_decode=True, **kw)
    reqs = make_traffic(cfg.vocab_size, 12, seed=1)
    recorded = [r.generated for r in serve_wave(loop, reqs)]
    loop.obs.registry.reset()
    loop.engine.verify_widths.clear()
    replay = [r.generated for r in serve_wave(loop, replayed(reqs, 100))]
    st = loop.stats
    if recorded != plain or replay != plain:
        fail(f"{GQA_ARCH} fp32 full width: spec tokens differ from plain tokens")
    if st.spec_accepted_tokens == 0 or max(loop.engine.verify_widths) <= 1:
        fail(f"{GQA_ARCH} fp32 full width: the replay accepted no draft or verified no "
             f"chunk wider than 1")
    print(json.dumps(dict(phase="spec_fp32_full", arch=GQA_ARCH, layers=cfg.n_layers,
                          d_model=cfg.d_model, requests=len(plain), identical_to_plain=True,
                          spec_drafted_tokens=st.spec_drafted_tokens,
                          spec_accepted_tokens=st.spec_accepted_tokens,
                          spec_acceptance_rate=st.spec_acceptance_rate,
                          verify_widths=sorted(loop.engine.verify_widths),
                          decode_steps=st.decode_steps, seconds=time.time() - t0)), flush=True)


def profile_serving(loop, cfg, path: str, out: Path) -> None:
    """torch.profiler window over a second wave of traffic (a spec loop:
    served once unprofiled, then replayed under the profiler): device
    time by kernel name (the full table is written to `out`)."""
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.time()
    reqs = make_traffic(cfg.vocab_size, 8, seed=2)
    if loop.spec:
        serve_wave(loop, reqs)
        reqs = replayed(reqs, 200)
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
    print(json.dumps(dict(phase="profile", path=path, wall_s=wall, device_busy_s=dev_us / 1e6,
                          device_busy_share=dev_us / 1e6 / wall,
                          seconds=time.time() - t_phase)),
          flush=True)
    print(table[:6000], flush=True)


def smoke_setup(arch: str):
    """fp32 smoke config of `arch`, its params and tier state on the CPU."""
    cfg = reduce_for_smoke(get_config(arch))
    cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    params = init_params(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    return cfg, params, fill_tiers_from_params(params, init_tiered_for_model(gen, cfg), cfg)


def _to(tree, d):
    return {k: _to(v, d) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(d)


def serve_smoke_parity(dev, arch: str, mode=None, plain=None) -> dict:
    """fp32 smoke `arch` served in `mode` (None: the defaults; else a key
    of MODES): the kernels on the card against the plain versions on the
    CPU, same weights and tier state -> same tokens. In spec mode a wave
    is served and then replayed (fresh rids), each wave's tokens must
    equal `plain` (the default mode's) and the replay must accept
    drafts. Returns the card's tokens by rid."""
    t0 = time.time()
    cfg, params, tiered = smoke_setup(arch)
    got, accepted = {}, {}
    for d in (dev, torch.device("cpu")):
        loop = ServingLoop(cfg, _to(params, d), _to(tiered, d), batch_size=4, n_groups=2,
                           cache_len=64, prefill_chunk_tokens=8, device=d,
                           **MODES.get(mode, {}))
        reqs = make_traffic(cfg.vocab_size, 6, seed=3, new_tokens=8)
        waves = [reqs, replayed(reqs, 100)] if mode == "spec" else [reqs]
        got[d.type] = {r.rid: list(r.generated) for w in waves for r in serve_wave(loop, w)}
        accepted[d.type] = loop.stats.spec_accepted_tokens
    if got["cuda"] != got["cpu"]:
        fail(f"{arch} ({mode or 'default'}) fp32 smoke serving: card tokens {got['cuda']} "
             f"!= CPU tokens {got['cpu']}")
    extra = {}
    if mode == "spec":
        want = {rid + off: toks for rid, toks in plain.items() for off in (0, 100)}
        if got["cuda"] != want:
            fail(f"{arch} fp32 smoke: spec tokens {got['cuda']} != plain tokens {want}")
        if min(accepted.values()) == 0:
            fail(f"{arch} fp32 smoke: the replayed spec wave accepted no draft ({accepted})")
        extra = dict(identical_to_plain=True, spec_accepted_tokens=accepted["cuda"])
    print(json.dumps(dict(phase="smoke_parity", arch=arch, mode=mode or "default",
                          requests=len(got["cpu"]), identical_tokens=True, **extra,
                          seconds=time.time() - t0)), flush=True)
    return got["cuda"]


def replay_parity(dev, arch: str) -> None:
    """`replay_requests` of a skewed trace (Zipf prompts, 2 phases with a
    re-permuted vocabulary, bursts of 3 every 2 iterations) through the
    fp32 smoke `arch`: the trace drains, and the card's tokens and
    iteration count equal the CPU's."""
    t0 = time.time()
    cfg, params, tiered = smoke_setup(arch)
    trace = synth_request_trace(9, cfg.vocab_size, prompt_len=12, prompt_len_jitter=4,
                                new_tokens=8, n_phases=2, burst=3, gap_steps=2, seed=7)
    res = {}
    for d in (dev, torch.device("cpu")):
        loop = ServingLoop(cfg, _to(params, d), _to(tiered, d), batch_size=4, n_groups=2,
                           cache_len=32, prefill_chunk_tokens=8, device=d)
        res[d.type] = replay_requests(loop, trace)
    got, want = res["cuda"], res["cpu"]
    if len(got.completions) != len(trace) or any(
            len(r.generated) != 8 for r in got.completions):
        fail(f"{arch} replay: {len(got.completions)}/{len(trace)} requests completed")
    if got.tokens() != want.tokens() or got.iterations != want.iterations:
        fail(f"{arch} replay: card tokens / iterations {got.tokens()} / {got.iterations} != "
             f"CPU's {want.tokens()} / {want.iterations}")
    print(json.dumps(dict(phase="replay_parity", arch=arch, requests=len(trace),
                          iterations=got.iterations, identical_tokens=True,
                          seconds=time.time() - t0)), flush=True)


def _recurrent_tokens(params, cfg, toks, lens, steps: int, paged: bool):
    """Prefill right-padded rows, then `steps` greedy decode steps, through
    the contiguous model functions or the paged ones (the rows' recurrent
    states beside the pools). Returns the logits of every step, stacked
    [steps + 1, B, V]."""
    dev = toks.device
    b, s = toks.shape
    mask = torch.arange(s, device=dev)[None, :] < lens[:, None]
    if paged:
        n_blocks = b * -(-(s + steps) // 4)
        pools, states = init_paged_cache(cfg, b, n_blocks, 4, device=dev)
        tables = torch.arange(n_blocks, dtype=torch.int32, device=dev).reshape(b, -1)
        logits, _, states = prefill_paged(params, cfg, toks, pools, tables,
                                          torch.zeros(b, dtype=torch.int32, device=dev), mask)
    else:
        logits, cache = prefill(params, cfg, toks, cache_len=s + steps, token_mask=mask)
    out, pos = [logits], lens.to(torch.int32)
    for _ in range(steps):
        nxt = out[-1].argmax(-1).to(torch.int32)[:, None]
        if paged:
            logits, _, states, _ = decode_step_paged(params, cfg, nxt, pools, states, tables,
                                                     pos)
        else:
            logits, cache, _ = decode_step(params, cfg, nxt, cache, pos)
        out.append(logits)
        pos = pos + 1
    return torch.stack(out)


def xlstm_phase(dev) -> None:
    """xlstm-125m at full width and depth (12 layers, d_model 768), bf16,
    seeded random weights: prefill of 4 right-padded rows (64, 40, 33 and
    57 real tokens), then 16 greedy decode steps, through the contiguous
    model functions (`prefill`, `decode_step`) and the paged ones
    (`prefill_paged`, `decode_step_paged` over the per-slot states: xLSTM
    has no pools). Both run the same plain functions on the same shapes,
    so their tokens must be equal, and none of the five kernels may
    launch (no Pallas kernel reaches xLSTM in the reference). Then the
    fp32 smoke config on the card and on the CPU from the same weights:
    logits within 1e-5 (abs + rel), equal tokens."""
    t_phase = time.time()
    cfg = get_config(XLSTM_ARCH)
    params = init_params(0, cfg, device=dev)
    gen = torch.Generator().manual_seed(6)
    lens = torch.tensor([64, 40, 33, 57], device=dev)
    toks = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen).to(dev)
    reset_counters()
    full, secs = {}, {}
    for paged in (False, True):
        torch.cuda.synchronize()
        t0 = time.time()
        full[paged] = _recurrent_tokens(params, cfg, toks, lens, 16, paged)
        torch.cuda.synchronize()
        secs[paged] = time.time() - t0
    launches = read_counters()
    if any(launches.values()):
        fail(f"{XLSTM_ARCH}: a kernel launched on a path without attention or MoE: {launches}")
    if not all(torch.isfinite(v.float()).all() for v in full.values()):
        fail(f"{XLSTM_ARCH}: non-finite logits at full width")
    if full[False].shape != (17, 4, cfg.vocab_size):
        fail(f"{XLSTM_ARCH}: logits of shape {tuple(full[False].shape)}")
    toks_c, toks_p = full[False].argmax(-1), full[True].argmax(-1)
    if not torch.equal(toks_c, toks_p):
        fail(f"{XLSTM_ARCH}: contiguous tokens {toks_c.tolist()} != paged {toks_p.tolist()}")
    # fp32 smoke: the card against the CPU, same weights and inputs
    scfg = dataclasses.replace(reduce_for_smoke(cfg), param_dtype="float32",
                               compute_dtype="float32")
    sp = init_params(0, scfg, device="cpu")
    stoks = torch.randint(0, scfg.vocab_size, (4, 16), generator=gen)
    slens = torch.tensor([16, 9, 12, 5])
    worst = 0.0
    for paged in (False, True):
        got = _recurrent_tokens(_to(sp, dev), scfg, stoks.to(dev), slens.to(dev), 8, paged)
        want = _recurrent_tokens(sp, scfg, stoks, slens, 8, paged)
        got = got.cpu()
        worst = max(worst, float(((got - want).abs() / (1e-5 + 1e-5 * want.abs())).max()))
        if not torch.equal(got.argmax(-1), want.argmax(-1)) or worst > 1:
            fail(f"{XLSTM_ARCH} fp32 smoke ({'paged' if paged else 'contiguous'}): card "
                 f"logits off the CPU's by {worst:.3f} of 1e-5, or other tokens")
    print(json.dumps(dict(
        phase="xlstm", arch=XLSTM_ARCH, layers=cfg.n_layers, d_model=cfg.d_model,
        dtype=cfg.param_dtype, rows=4, decode_steps=16, contiguous_s=secs[False],
        paged_s=secs[True], identical_tokens=True, launches=launches,
        smoke_fp32_err_over_tol=worst, seconds=time.time() - t_phase)), flush=True)


def mamba_phase(dev) -> None:
    """One jamba Mamba layer at published widths (d_model 4096, d_inner
    8192, d_state 16, d_conv 4, dt_rank 256), bf16, seeded random weights:
    the eager call time (CUDA events around a loop, host cost included)
    and the device time (the profiler's kernel time) of its masked
    forward over the 64-token whole-suffix bucket of 4 rows, of the chunk
    scan alone on that call's fp32 [4, 64, 8192, 16] transitions, and of
    a decode step of 4 rows. Section 5 of PERF.md reads the Mamba
    layers' and the scan's share of a serve from them."""
    from repro_torch.models.mamba import init_mamba

    t_phase = time.time()
    cfg = get_config(JAMBA_ARCH)
    gen = torch.Generator(device=dev).manual_seed(3)
    p = init_mamba(gen, cfg)
    x = torch.randn(4, 64, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
    mask = torch.arange(64, device=dev)[None, :] < torch.tensor([64, 40, 33, 57],
                                                                device=dev)[:, None]
    di, n = 2 * cfg.d_model, cfg.mamba.d_state
    a = torch.rand(4, 64, di, n, generator=gen, device=dev)
    b = torch.randn(4, 64, di, n, generator=gen, device=dev)
    _, state = mamba_forward(p, cfg, x, return_state=True, token_mask=mask)
    calls = dict(
        prefill=lambda: mamba_forward(p, cfg, x, return_state=True, token_mask=mask),
        scan=lambda: _assoc_scan(a, b),
        decode=lambda: mamba_decode(p, cfg, x[:, :1], state),
    )
    out = {}
    for name, fn in calls.items():
        out[f"{name}_ms"] = call_time_ms(fn, 10)
        out[f"{name}_device_ms"] = profiled_device_ms(fn, 10)
    print(json.dumps(dict(phase="mamba", arch=JAMBA_ARCH, d_model=cfg.d_model, d_inner=di,
                          d_state=n, rows=4, bucket=64, **out,
                          seconds=time.time() - t_phase)), flush=True)


# ------------------------------------------------------------- training
GRAD_NAMES = ("out", "dh", "dw_gate", "dw_up", "dw_down")


def _with_grads(fn, inputs, dy):
    """fn's output and the gradients of <output, dy> with respect to each
    input (fresh leaves)."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    out.backward(dy)
    return [out.detach()] + [t.grad for t in leaves]


def _train_widths():
    """granite's MoE widths and the capacity of its global dispatch at the
    train phase's batch: (E, D, F, cap)."""
    cfg = get_config(GQA_ARCH)
    mo, t = cfg.moe, TRAIN_B * TRAIN_S
    cap = min(t, max(mo.top_k, int(t * mo.top_k * mo.capacity_factor / mo.n_experts + 0.5)))
    return mo.n_experts, cfg.d_model, mo.d_expert, cap


def grad_phase(dev) -> dict:
    """The differentiable moe_gemm at granite's training widths: the
    expert buffers of one MoE layer's global dispatch at batch 8 x 512
    (h [32, 1280, 1024], F 512). `grouped_expert_ffn`'s output and its
    gradients (dh, dW_gate, dW_up, dW_down) on the kernel route against
    the plain route's autograd, in bf16 (per element to
    `grad_rounding_bound`) and fp32 (TOL). Then the two dX products of the
    backward alone, in bf16: device time of the kernel (CUDA-graph
    replay), the plain version and torch.bmm over the same operands, and
    their bound. Returns the dX rows by name."""
    t_phase = time.time()
    e, d, f, cap = _train_widths()
    gen = torch.Generator().manual_seed(8)
    c_pad = -(-cap // 128) * 128  # the buffers' rows as the GEMM pads them
    te = torch.arange(e, dtype=torch.int32, device=dev).repeat_interleave(c_pad // 128)
    held, rows = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        h = torch.randn(e, cap, d, generator=gen).to(dev, dtype)
        ws = [(torch.randn(*shape, generator=gen) * shape[1] ** -0.5).to(dev, dtype)
              for shape in ((e, d, f), (e, d, f), (e, f, d))]
        dy = (torch.randn(e, cap, d, generator=gen) * cap ** -0.5).to(dev, dtype)
        got = _with_grads(lambda *a: grouped_expert_ffn(*a, backend="cuda"), (h, *ws), dy)
        want = _with_grads(lambda *a: grouped_expert_ffn(*a, backend="ref"), (h, *ws), dy)
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        for name, g, w in zip(GRAD_NAMES, got, want):
            tol = grad_rounding_bound(w) if bf16 else None
            max_abs, _, over = compare(f"moe_gemm gradient {name}", g, w, dtype, tol)
            held[f"{name}/{str(dtype)[6:]}"] = dict(max_abs_err=max_abs, err_over_tol=over)
        del got, want
        if not bf16:
            continue
        w_gu = torch.cat(ws[:2], -1)
        products = {  # name -> (dY [M, N], the weight read transposed [E, N, K])
            "dx_gate_up": (torch.randn(e * c_pad, 2 * f, generator=gen).to(dev, dtype),
                           w_gu.transpose(1, 2)),
            "dx_down": (torch.randn(e * c_pad, d, generator=gen).to(dev, dtype),
                        ws[2].transpose(1, 2)),
        }
        for name, (a, wt) in products.items():
            m, n = a.shape
            k = wt.shape[2]
            isz = a.element_size()
            sets = [(a, wt), (a.flip(0).contiguous(), wt)]  # dY alone exceeds L2
            max_abs, _, _ = compare(f"moe_gemm {name}", gemm_launch(a, wt, te, 128),
                                    moe_gemm_ref(a, wt, te), dtype, TOL[dtype])
            b_ms, b_by = bound_ms((m * n + e * n * k + m * k) * isz, 2.0 * m * n * k, dtype)
            rows[name] = dict(
                shape=[m, n, k], max_abs_err=max_abs,
                kernel_ms=device_time_ms(lambda x, w: gemm_launch(x, w, te, 128), sets,
                                         calls=8),
                plain_ms=device_time_ms(lambda x, w: moe_gemm_ref(x, w, te), sets, calls=8),
                library_ms=device_time_ms(lambda x, w: torch.bmm(x.view(e, c_pad, n), w), sets,
                                          calls=8),
                bound_ms=b_ms, bound_by=b_by)
    print(json.dumps(dict(phase="gradient", arch=GQA_ARCH, experts=e, cap=cap, d_model=d,
                          d_expert=f, held=held, dx=rows, seconds=time.time() - t_phase)),
          flush=True)
    return rows


def _batches(cfg, b: int, s: int, dev, n: int = 2) -> list:
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    return [{k: torch.as_tensor(v, device=dev) for k, v in corpus.batch(i, b, s).items()}
            for i in range(n)]


def train_phase(dev, profile_out=None) -> list:
    """granite-moe-1b-a400m at published width and full depth (24 layers,
    d 1024, 32 experts top-8), bf16 params from a seed, trained for 8
    steps of batch 8 x 512 from `SyntheticCorpus` (batches i % 2, as the
    reference's tests train), AdamW lr 1e-3 with 2 warm-up steps, with
    the launch counters reset just before. Every loss finite, the last
    below the first; moe_gemm launches 6 times per MoE layer and step
    (forward, recompute under remat, dX; two GEMMs each) and no other
    kernel launches. Then a model-level generate with the trained
    weights and no tiers (`prefill` of 4 x 32 tokens, 16 `decode_step`s):
    moe_gemm on the prefill, the GEMV on the decode steps. Returns the
    two paths' launch counts."""
    t_phase = time.time()
    cfg = get_config(GQA_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    params, opt = init_train_state(0, cfg, TRAIN_OPT, device=dev)
    step = make_train_step(cfg, TRAIN_OPT)
    batches = _batches(cfg, TRAIN_B, TRAIN_S, dev)
    n_moe = sum(cfg.uses_moe_layer(i) for i in range(cfg.n_layers))
    torch.cuda.synchronize()
    setup_s = time.time() - t_phase
    reset_counters()
    losses, secs = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.time()
        params, opt, metrics = step(params, opt, batches[i % 2])
        losses.append(float(metrics["loss"]))  # synchronises
        secs.append(time.time() - t0)
    launches = read_counters()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"{TRAIN_PATH}: losses {losses} are not finite and falling")
    if launches["moe_gemm"] != 6 * n_moe * TRAIN_STEPS:
        fail(f"{TRAIN_PATH}: moe_gemm launched {launches['moe_gemm']} times, not 6 per MoE "
             f"layer and step (forward, recompute, dX): {launches}")
    off = {k: v for k, v in launches.items() if k != "moe_gemm" and v}
    if off:
        fail(f"{TRAIN_PATH}: kernels off the training path launched: {off}")
    step_s = sorted(secs[1:])[len(secs[1:]) // 2]
    # the trained weights, served by the model functions without tiers
    gen = torch.Generator().manual_seed(9)
    toks = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen).to(dev)
    reset_counters()
    t0 = time.time()
    with torch.no_grad():
        logits, cache = prefill(params, cfg, toks, cache_len=48)
        prefill_launches = read_counters()
        out = [logits]
        for pos in range(32, 48):
            nxt = out[-1].argmax(-1, keepdim=True).to(torch.int32)
            logits, cache, _ = decode_step(params, cfg, nxt, cache, pos)
            out.append(logits)
    torch.cuda.synchronize()
    gen_s = time.time() - t0
    gen_launches = read_counters()
    if not all(torch.isfinite(o.float()).all() for o in out):
        fail(f"{GENERATE_PATH}: non-finite logits")
    if prefill_launches["moe_gemm"] == 0 or gen_launches["expert_ffn_gemv"] == 0:
        fail(f"{GENERATE_PATH}: prefill launches {prefill_launches}, all {gen_launches}: "
             f"moe_gemm must run the prefill, the GEMV the decode steps")
    if any(gen_launches[k] for k in ("paged_prefill_gqa", "paged_prefill_mla",
                                     "flash_attention")):
        fail(f"{GENERATE_PATH}: attention kernels launched off their path: {gen_launches}")
    print(json.dumps(dict(
        phase="train", path=TRAIN_PATH, arch=GQA_ARCH, layers=cfg.n_layers,
        d_model=cfg.d_model, experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
        dtype=cfg.param_dtype, batch=TRAIN_B, seq=TRAIN_S, steps=TRAIN_STEPS,
        losses=losses, step_s=secs, median_step_s=step_s,
        tokens_per_s=TRAIN_B * TRAIN_S / step_s, peak_mem_gb=peak_gb, setup_s=setup_s,
        launches=launches, moe_gemm_launches_per_step=launches["moe_gemm"] / TRAIN_STEPS,
        generate_s=gen_s, generate_launches=gen_launches,
        seconds=time.time() - t_phase)), flush=True)
    if profile_out is not None:
        profile_train(step, params, opt, batches, Path(profile_out))
    return [dict(path=TRAIN_PATH, launches=launches),
            dict(path=GENERATE_PATH, launches=gen_launches)]


def profile_train(step, params, opt, batches, out: Path) -> None:
    """torch.profiler window over 2 train steps: device busy share and
    device time by kernel name (the full table goes to `out`'s stem-train)."""
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.time()
    step(params, opt, batches[0])  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for i in range(2):
            params, opt, metrics = step(params, opt, batches[i % 2])
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.time() - t0
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    path = out.with_name(f"{out.stem}-train{out.suffix}")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(table)
    dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    print(json.dumps(dict(phase="profile", path=TRAIN_PATH, steps=2, wall_s=wall,
                          device_busy_s=dev_us / 1e6, device_busy_share=dev_us / 1e6 / wall,
                          seconds=time.time() - t_phase)), flush=True)
    print(table[:6000], flush=True)


def _over(got, want) -> list:
    """[(leaf path, (largest err / tol, elements over, elements))] of the
    tree `got` against `want`, worst first: tol = 1e-5 * (|want| + the
    leaf's largest |want|), relative to the element plus its leaf's
    scale, for elements near 0."""
    ref = dict(leaves_with_path(want))
    over = {}
    for path, leaf in leaves_with_path(got):
        w = ref[path].float().cpu()
        err = (leaf.float().cpu() - w).abs()
        r = err / (1e-5 * (w.abs() + w.abs().max())).clamp_min(1e-30)
        over["|".join(map(str, path))] = (float(r.max()), int((r > 1).sum()), r.numel())
    return sorted(over.items(), key=lambda kv: -kv[1][0])


def _off_grad(got, want, grads, leaf: str):
    """The largest first-step |gradient| where `leaf` of the state `got`
    is off `want`'s (to `_over`'s tol), over the leaf's largest; None for
    a leaf with no gradient (the step count)."""
    path = leaf.split("|")
    gpath = (path[1:] if path[0] == "params"
             else path[2:] if path[1] in ("m", "v") else None)
    if gpath is None:
        return None

    def by_path(tree):
        return {"|".join(map(str, k)): v.float().cpu() for k, v in leaves_with_path(tree)}

    g = by_path(grads)["|".join(gpath)].abs()
    a, w = by_path(got)[leaf], by_path(want)[leaf]
    off = (a - w).abs() > 1e-5 * (w.abs() + w.abs().max())
    return float(g[off].max() / g.max()) if off.any() else 0.0


def train_smoke_parity(dev) -> None:
    """The fp32 smoke granite config on the card (the kernels) and on the
    CPU (the plain versions) from the same weights and batches. Held, to
    `_over`'s 1e-5: the first step's gradients (before Adam's division,
    so at any learning rate), then every param and optimizer leaf after
    two steps of AdamW at its defaults (lr 3e-4 over 100 warm-up steps);
    the expert counts of the first step and after training are equal.
    Reported, not held: the same two steps at the train phase's lr 1e-3,
    its three farthest leaves and, for the farthest, how large the first
    step's gradient is where its elements are off (relative to the
    leaf's largest): Adam's first update is g / (|g| + eps), so an
    element whose gradient is near 0 may move by up to 2 lr for a
    rounding-sized change of it. Then the card's state saved as a
    checkpoint and restored on the CPU equals it bitwise."""
    t0 = time.time()
    cfg = reduce_for_smoke(get_config(GQA_ARCH))
    cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    params = init_params(0, cfg, device="cpu")
    runs = {}
    for d in (dev, torch.device("cpu")):
        p = _to(params, d)
        batches = _batches(cfg, 4, 32, d)
        _, metrics, grads = value_and_grad(p, cfg, batches[0])
        run = dict(grads=grads)
        for name, opt in (("defaults", AdamWConfig()), ("lr1e-3", TRAIN_OPT)):
            q, o = p, adamw_init(p, opt)
            step = make_train_step(cfg, opt)
            for i in range(2):
                q, o, _ = step(q, o, batches[i % 2])
            run[name] = {"params": q, "opt": o}
        with torch.no_grad():
            after = forward_train(run["defaults"]["params"], cfg, batches[0])[2]
        run["counts"] = (metrics["expert_counts"].cpu(), after.cpu())
        runs[d.type] = run
    card, cpu = runs["cuda"], runs["cpu"]
    if not all(torch.equal(a, b) for a, b in zip(card["counts"], cpu["counts"])):
        fail(f"fp32 smoke train: card expert counts {card['counts']} != CPU's {cpu['counts']}")
    grad_worst = _over(card["grads"], cpu["grads"])
    if grad_worst[0][1][0] > 1:
        fail(f"fp32 smoke train: card gradients off the CPU's; worst leaves (err / tol, "
             f"elements over, elements): {grad_worst[:6]}")
    worst = _over(card["defaults"], cpu["defaults"])
    if worst[0][1][0] > 1:
        fail(f"fp32 smoke train: card state off the CPU's; worst leaves (err / tol, elements "
             f"over, elements): {worst[:6]}")
    lr_worst = _over(card["lr1e-3"], cpu["lr1e-3"])
    off_grad = _off_grad(card["lr1e-3"], cpu["lr1e-3"], cpu["grads"], lr_worst[0][0])
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as ckpt:
        save(ckpt, 2, card["defaults"])
        got = restore(ckpt, 2, tree_map(lambda t: torch.zeros_like(t, device="cpu"),
                                         card["defaults"]))
    restored = dict(leaves_with_path(got))
    for path, leaf in leaves_with_path(card["defaults"]):
        if not torch.equal(restored[path], leaf.cpu()):
            fail(f"fp32 smoke train: checkpoint leaf {path} restored on the CPU differs")
    print(json.dumps(dict(phase="train_smoke_parity", arch=cfg.name, steps=2,
                          grad_err_over_tol=grad_worst[0][1][0], grad_worst_leaf=grad_worst[0][0],
                          err_over_tol=worst[0][1][0], worst_leaf=worst[0][0],
                          lr1e3_not_held=dict(worst_leaves=lr_worst[:3],
                                              off_elements_grad_over_leaf_max=off_grad),
                          identical_counts=True, checkpoint_restored_bitwise=True,
                          seconds=time.time() - t0)), flush=True)


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
    t0 = time.time()
    tool = build.cuobjdump()
    if tool is None:
        fail("no cuobjdump beside nvcc or in Triton: cannot read the kernels' SASS")
    mma = {name: build.count_mma(tool, name) for name in build.SOURCES}
    print(json.dumps(dict(phase="sass", mma=mma, seconds=time.time() - t0)), flush=True)
    for name, op in TENSOR_CORE_KERNELS.items():
        if mma[name][op] == 0:
            fail(f"{name}: no {op} (tensor-core) instruction in its SASS")

    rows = kernel_phases(dev)
    paths = [mha_entry(dev)]
    mamba_phase(dev)
    xlstm_phase(dev)
    dx = grad_phase(dev)
    train_paths = train_phase(dev, profile_out=args.profile_out if args.profile else None)
    paths += train_paths
    for row in dx.values():  # each dX product runs once a MoE layer a step
        row["launches_per_step"] = train_paths[0]["launches"]["moe_gemm"] // (6 * TRAIN_STEPS)
    train_smoke_parity(dev)
    gc.collect()
    torch.cuda.empty_cache()
    for arch, n_layers, mode, expect, forbid in SERVES:
        paths.append(serve_full(dev, arch, n_layers, mode, expect, forbid,
                                profile_out=args.profile_out if args.profile else None,
                                plain_tokens=next((p["tokens"] for p in paths
                                                   if p["path"] == arch), None)))
        gc.collect()
        torch.cuda.empty_cache()  # the loop's weights and tiers, before the next one
    spec_fp32_full(dev)
    gc.collect()
    torch.cuda.empty_cache()
    for arch in (GQA_ARCH, MLA_ARCH):
        plain = serve_smoke_parity(dev, arch)
        for mode in MODES:
            serve_smoke_parity(dev, arch, mode, plain)
        replay_parity(dev, arch)
    for mode in (None, "slots"):  # jamba: the paged default admits whole suffixes
        serve_smoke_parity(dev, JAMBA_ARCH, mode)

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
        if name == "moe_gemm":  # the dX products of the train step's backward
            kernels[-1]["train_dx"] = dx
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
