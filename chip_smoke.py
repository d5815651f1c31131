"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA H100.

  python3 chip_smoke.py            # what CI runs: build, kernel phases, serve
  python3 chip_smoke.py --profile  # also a torch.profiler window of each serve
                                   # (full tables: --profile-out PATH, one file
                                   # per model, named PATH's stem-<arch>)
  python3 chip_smoke.py --only kernels,dense --cases dense
                                   # some phases alone (names in PHASES), the
                                   # kernel rows whose label holds a word of
                                   # --cases; no `kernels` line

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
     equal expert counts; the lr 1e-3 state of the kernels and of the
     plain route reported) and a checkpoint of the card's state restored
     on the CPU bitwise; serve seamless-m4t-large-v2 (encoder-decoder) at
     full width and depth at the model level (the encoder over 4 x 1024
     frames, a masked prefill storing the cross K/V, 16 decode steps; no
     kernel launched; fp32 smoke logits on the card within 1e-5 of the
     CPU's) and train it for 6 steps of 4 x 256 tokens with frames
     (finite, falling loss; no kernel launched); the distributed layer
     on a (1, 1) NCCL mesh (world size 1): granite at full width and depth,
     4 steps through the mesh train step, its state bitwise equal to the
     unsharded step's (both under deterministic algorithms), moe_gemm 6
     launches a MoE layer a step, the params restored with shardings,
     `compressed_psum` over NCCL, and one MoE layer's grouped dispatch with
     the MoE hints against the plain route; the serving functions' mesh
     path on a (1, 1) NCCL mesh ("mesh_serve"): granite at full width and
     depth, tiers (8, 10, 14), jamba at full width (8 layers in bf16, 5
     in fp32, tiers (4, 5, 7)), xlstm-125m and seamless-m4t-large-v2 at
     full width and depth, a masked prefill of 8 rows and 16 decode
     steps each, fp32 tokens identical to the unsharded path's and logits
     within 1e-5, bf16 GEMV 3 launches a MoE layer a step on both paths
     (granite 72, jamba 12) and moe_gemm 6 a MoE layer in the prefill,
     none of the five kernels for xlstm and seamless, each path's decode
     p50, and the dry-run's fake-tensor trace of each cell at world size
     1 (its temporaries beside the card's); the dense family:
     granite-20b (MQA: 48 query heads over 1 KV head, hd 128) at published
     width with its depth cut to 44 layers, 4 right-padded rows through
     `prefill_paged` and 16 greedy `decode_step_paged` steps (the paged GQA
     kernel, exactly one launch a layer per call, no other kernel), then
     through `prefill` / `decode_step` (plain attention, no kernel):
     finite logits, the routes' token agreement and logit gap reported;
     and the five dense archs' fp32 smoke configs at their published G
     (3, 3, 5, 8, 48), card against CPU within 1e-5 with equal tokens;
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
     default and slots modes;
  6. the port's entry points, each run as `python <script>` runs it (its
     `__main__` block, in this process) on the card with the launch
     counters reset just before: tools/export_trace_torch.py at its
     defaults into profile_out/ (every `kernel.<op>` span with backend
     "cuda"), then its `--check`; and the three examples (quickstart_torch,
     serve_moe_offload_torch, train_small_moe_torch at the JAX example's
     200 steps), each exit 0; each must launch the kernels of its path
     (ENTRY_KERNELS) and no other. Their smoke-width shapes are kernel rows
     of phase 2 ("smoke ...").
`--profile` also profiles 2 train steps and granite-20b's decode. Prints
one JSON line per phase (each with its seconds), the `kernels` JSON line
(moe_gemm's with its train-step dX rows, paged_prefill_gqa's with the
dense family's rows, three kernels' with their smoke-width rows), the
card's name and power limit, and last the `ok` JSON line.
Imports nothing of JAX: the machine with the card has none.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import runpy
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
from repro_torch.data.pipeline import SyntheticCorpus, add_frames  # noqa: E402
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
ENCDEC_ARCH = "seamless-m4t-large-v2"  # served and trained at full width and depth
SEAMLESS_PATH, SEAMLESS_TRAIN_PATH = "seamless", "seamless_train"
SEAMLESS_TRAIN_B, SEAMLESS_TRAIN_S, SEAMLESS_TRAIN_STEPS = 4, 256, 6
# loop arguments by arch: jamba's tiers as explicit sizes (4 hot slots;
# the cold buffer pads to 16 slots: ~35 GB of tier buffers at 8 layers)
ARCH_LOOP_KW = {JAMBA_ARCH: dict(sizes=TierSizes(4, 5, 7))}
MHA_PATH = "mha"
DENSE_ARCH = "granite-20b"  # 48 query heads over 1 KV head (MQA), hd 128
# granite-20b depth cut 52 -> 44: `dense_init` draws each stacked leaf in
# fp32 before the bf16 cast, so init peaks at the params plus the last FFN
# leaf's fp32 draw, ~1.69 GB a layer (32 layers: 55.00 GB on an H100). At 52
# that is ~88 GB, over the card's 85; 44 (~75 GB) is the deepest that
# leaves ~10 GB for the run and the allocator (46 would leave ~6)
DENSE_LAYERS = 44
DENSE_PATH = "dense"
DENSE_STEPS = 16
# the dense rows whose shapes the dense phase runs, and which of its calls
# (prefill first, then the decode steps) launch them: the decode step
# (the phase's tables are 20 blocks, its pasts 33 to 79) and the bucket
DENSE_DECODE = "dense decode B=4 Kv=1 G=48 hd=128 nb=18"
DENSE_BUCKET = "dense prefill B=4 C=64 Kv=1 G=48 hd=128 nb=20"
DENSE_ROW_CALLS = {DENSE_DECODE: slice(1, None), DENSE_BUCKET: slice(0, 1)}
DENSE_ARCHS = ("llama3.2-3b", "phi4-mini-3.8b", "qwen2.5-32b", "chameleon-34b", DENSE_ARCH)
TRAIN_PATH = "train"  # granite-moe-1b-a400m trained at full width and depth
GENERATE_PATH = "train/generate"  # then prefill + decode of the flat MoE model
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 512, 8
TRAIN_OPT = AdamWConfig(lr=1e-3, warmup_steps=2)
DIST_PATH = "distributed"  # the mesh train step of granite on a (1, 1) NCCL mesh
DIST_GROUPED_PATH = "distributed/grouped"  # one MoE layer's grouped dispatch, hints on
DIST_STEPS = 4
# bf16 roundings of a MoE layer's output: 4 in an expert's FFN, the
# router weight's product, and 8 in the bf16 combine of top-k = 8
LAYER_ROUNDINGS = 13
GROUPED_GU = "grouped dispatch gate|up 256x160x1024x1024 (8 rows x 32 experts)"
GROUPED_DOWN = "grouped dispatch down 256x160x512x1024 (8 rows x 32 experts)"
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


def grouped_case(dtype, *, b, e, cap, d, f, pair, dev, gen, calls=8):
    """The grouped dispatch's expert FFN at granite's train width under the
    MoE hints on a (1, 1) mesh: b rows x e local experts as groups of `cap`
    rows (padded to 128) over the model's own [e, d, f] parameters, group g
    reading expert g % e through the GEMM's group -> expert indirection
    (gate|up over the [e, d, 2f] panel `grouped_expert_ffn` joins, down over
    the row-major [e, f, d] parameter). Library: torch.bmm with the groups
    regrouped by expert ([e, b * cap_pad, k], copied beforehand), which
    reads each expert's weights once as the kernel does. The bound counts
    the real rows."""
    bm = 128
    k, n = (d, 2 * f) if pair else (f, d)
    c_pad = -(-cap // bm) * bm
    w = (torch.randn(e, k, n, generator=gen) * k ** -0.5).to(dev, dtype)
    x = torch.zeros(b * e, c_pad, k, dtype=dtype, device=dev)
    x[:, :cap] = torch.randn(b * e, cap, k, generator=gen).to(dev, dtype)
    te = torch.arange(e, dtype=torch.int32, device=dev).repeat(b).repeat_interleave(c_pad // bm)
    by_expert = x.view(b, e, c_pad, k).transpose(0, 1).reshape(e, b * c_pad, k).contiguous()
    x = x.reshape(b * e * c_pad, k)
    real = b * e * cap
    isz = x.element_size()
    return dict(
        args=(x, w, te), lib_args=(by_expert, w),
        kernel=lambda *a: moe_gemm(*a, backend="cuda"),
        plain=lambda *a: moe_gemm(*a, backend="ref"),
        library=torch.bmm,
        held=(x.numel() + w.numel()) * isz,
        bound=bound_ms((real * k + e * k * n + real * n) * isz, 2.0 * real * k * n, dtype),
        calls=calls,
    )


def gemv_case(dtype, *, n_slots, t, dev, gen, d=1024, f=512, live=None, calls=32,
              flat=False, ops=False):
    """One tier of a decode step: n_slots experts, t tokens each, read as
    views of the [n, 3, D, F] tier buffer (down matrix transposed).
    `flat`: the flat MoE's decode step instead, all experts as slots over
    the model's own parameters, the row-major [E, F, D] w_down read in
    place, through `cold_expert_ffn` as the model calls it; in bf16 also
    timed as `copied`: w_down first copied into the tier layout, as the
    wrapper did before the down pass read the row-major layout. `ops`:
    the tier views through `cold_expert_ffn`, as the tier FFN calls it
    (fp32 zero-pads an F that is no multiple of the kernel's panel). With
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
    launch = cold_expert_ffn if flat or ops else expert_ffn_gemv

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
    # the dense family's (Kv, G) pairs at hd 128: llama3.2-3b and
    # phi4-mini (8, 3), qwen2.5-32b (8, 5), chameleon-34b (8, 8),
    # granite-20b (1, 48: MQA), a decode step over 18 blocks; chunks of
    # 32 for (8, 5) and (1, 48); granite-20b's 64-token bucket as the
    # dense phase feeds it (3072 query rows a KV head, its 20-block tables)
    ("paged_prefill_gqa", "dense decode B=4 Kv=8 G=3 hd=128 nb=18", attention_case,
     dict(b=4, c=1, nb=18, past=[40, 51, 60, 71], kv=8, g=3, hd=128)),
    ("paged_prefill_gqa", "dense decode B=4 Kv=8 G=5 hd=128 nb=18", attention_case,
     dict(b=4, c=1, nb=18, past=[40, 51, 60, 71], kv=8, g=5, hd=128)),
    ("paged_prefill_gqa", "dense decode B=4 Kv=8 G=8 hd=128 nb=18", attention_case,
     dict(b=4, c=1, nb=18, past=[40, 51, 60, 71], kv=8, g=8, hd=128)),
    ("paged_prefill_gqa", DENSE_DECODE, attention_case,
     dict(b=4, c=1, nb=18, past=[40, 51, 60, 71], kv=1, g=48, hd=128)),
    ("paged_prefill_gqa", "dense prefill B=4 C=32 Kv=8 G=5 hd=128 nb=18", attention_case,
     dict(b=4, c=32, nb=18, past=[0, 16, 24, 40], kv=8, g=5, hd=128)),
    ("paged_prefill_gqa", "dense prefill B=4 C=32 Kv=1 G=48 hd=128 nb=18", attention_case,
     dict(b=4, c=32, nb=18, past=[0, 16, 24, 40], kv=1, g=48, hd=128)),
    ("paged_prefill_gqa", DENSE_BUCKET, attention_case,
     dict(b=4, c=64, nb=20, past=[0, 0, 0, 0], lens=[64, 40, 33, 57], kv=1, g=48, hd=128)),
    # the smoke-width serves of the entry points (granite-moe's smoke
    # config: 4 heads over 4 KV heads, hd 16, d_model 64, 8 experts of
    # d_expert 32, top-2; bf16): a decode step of a group of 2 over its
    # 8-block table, a 16-token prefill chunk; the prefill's grouped expert
    # FFN over 16 slots of 128 rows (gate|up joined, down row-major) and
    # the train example's 8 experts of 256 rows; the decode's cold (16
    # slots) and hot (2 slots) GEMV tiers at 2 tokens a slot
    ("paged_prefill_gqa", "smoke decode B=2 Kv=4 G=1 hd=16 nb=8", attention_case,
     dict(b=2, c=1, nb=8, past=[13, 30], kv=4, g=1, hd=16)),
    ("paged_prefill_gqa", "smoke prefill B=4 C=16 Kv=4 G=1 hd=16 nb=4", attention_case,
     dict(b=4, c=16, nb=4, past=[0, 0, 0, 0], lens=[16, 12, 8, 16], kv=4, g=1, hd=16)),
    ("moe_gemm", "smoke gate|up 16x128x64x64 joined", moe_gemm_case,
     dict(n_slots=16, rows=8, d=64, f=32, pair=True, flat=True)),
    ("moe_gemm", "smoke down 16x128x32x64 row-major", moe_gemm_case,
     dict(n_slots=16, rows=8, d=64, f=32, pair=False, flat=True)),
    ("moe_gemm", "smoke train gate|up 8x256x64x64 joined", moe_gemm_case,
     dict(n_slots=8, rows=160, d=64, f=32, pair=True, flat=True)),
    ("moe_gemm", "smoke train down 8x256x32x64 row-major", moe_gemm_case,
     dict(n_slots=8, rows=160, d=64, f=32, pair=False, flat=True)),
    ("expert_ffn_gemv", "smoke cold 16 slots T=2 D=64 F=32", gemv_case,
     dict(n_slots=16, t=2, d=64, f=32)),
    ("expert_ffn_gemv", "smoke hot 2 slots T=2 D=64 F=32", gemv_case,
     dict(n_slots=2, t=2, d=64, f=32)),
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
    # deepseek's warm tier as one rank of a 16-wide "model" axis holds it
    # on the mesh path (F 1536 / 16 = 96 columns of every expert): the
    # GEMV on the shard's views through `cold_expert_ffn` (fp32 pads F to
    # 128), gate|up joined by torch.cat (96 is no multiple of the bf16
    # pair's 64-column box), down on the tier view
    ("expert_ffn_gemv", "mesh shard deepseek warm 48 slots T=4 F=96, 8 live", gemv_case,
     dict(n_slots=48, t=4, d=5120, f=96, live=8, calls=8, ops=True)),
    ("moe_gemm", "mesh shard deepseek warm gate|up 48x128x5120x192 joined", moe_gemm_case,
     dict(n_slots=48, rows=128, d=5120, f=96, pair=True, flat=True, calls=8)),
    ("moe_gemm", "mesh shard deepseek warm down 48x128x96x5120", moe_gemm_case,
     dict(n_slots=48, rows=128, d=5120, f=96, pair=False, calls=8)),
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
    # the distributed phase's grouped dispatch under the MoE hints: granite
    # at its train batch (8 rows x 512 tokens, capacity 160 a row and
    # expert), the 8 x 32 groups over the rank's 32 experts of a (1, 1) mesh
    ("moe_gemm", GROUPED_GU, grouped_case,
     dict(b=TRAIN_B, e=32, cap=160, d=1024, f=512, pair=True)),
    ("moe_gemm", GROUPED_DOWN, grouped_case,
     dict(b=TRAIN_B, e=32, cap=160, d=1024, f=512, pair=False)),
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


DENSE_LABELS = [label for _, label, _, _ in KERNEL_CASES if label.startswith("dense ")]
SMOKE_LABELS = [(name, label) for name, label, _, _ in KERNEL_CASES
                if label.startswith("smoke ")]


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


def kernel_phases(dev, words=None) -> dict:
    """Every row of KERNEL_CASES in bf16 and fp32 (with `words`, only the
    rows whose label holds one of them); returns each kernel's first bf16
    row and the bf16 rows by label."""
    gen = torch.Generator().manual_seed(0)
    rows, by_label = {}, {}
    for name, label, make, kw in KERNEL_CASES:
        if words and not any(w in label for w in words):
            continue
        for dtype in (torch.bfloat16, torch.float32):
            line = run_case(name, label, make, dtype, kw, dev, gen)
            print(json.dumps(line), flush=True)
            if dtype == torch.bfloat16:
                rows.setdefault(name, line)
                by_label[label] = line
    return rows, by_label


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


def _recurrent_tokens(params, cfg, toks, lens, steps: int, paged: bool, calls=None):
    """Prefill right-padded rows, then `steps` greedy decode steps, through
    the contiguous model functions or the paged ones (the rows' recurrent
    states beside the pools). Returns the logits of every step, stacked
    [steps + 1, B, V]. `calls`, a list, gets (the host clock after a
    device synchronisation, the launch counters) after the prefill and
    after each decode step."""
    def done():
        if calls is not None:
            torch.cuda.synchronize()
            calls.append((time.time(), read_counters()))

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
    done()
    out, pos = [logits], lens.to(torch.int32)
    for _ in range(steps):
        nxt = out[-1].argmax(-1).to(torch.int32)[:, None]
        if paged:
            logits, _, states, _ = decode_step_paged(params, cfg, nxt, pools, states, tables,
                                                     pos)
        else:
            logits, cache, _ = decode_step(params, cfg, nxt, cache, pos)
        done()
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


# ---------------------------------------------------------- dense family
def keep_groups(smoke, pub):
    """`smoke`, the smoke reduction of the published config `pub` of a
    dense arch, made fp32 and given back the published G (query heads a
    KV head): KV heads cut to at most 2, query heads G times as many,
    head width 16, the published rope_theta (the smoke reduction resets
    it); qkv_bias and tied embeddings stay as published. Works on either
    package's configs, so the CPU tests build the reference's alike."""
    kv = min(2, pub.n_kv_heads)
    return dataclasses.replace(smoke, n_heads=pub.n_heads // pub.n_kv_heads * kv,
                               n_kv_heads=kv, head_dim=16, rope_theta=pub.rope_theta,
                               param_dtype="float32", compute_dtype="float32")


def profile_dense(params, cfg, toks, lens, out: Path) -> None:
    """torch.profiler over granite-20b's prefill and 8 decode steps (the
    dense phase's inputs, after a warm-up), through the paged route and
    then the plain one: wall and device-busy time, the top ops by device
    and by host time (full tables to `out`)."""
    from torch.profiler import ProfilerActivity, profile

    tables = []
    for paged in (True, False):
        _recurrent_tokens(params, cfg, toks, lens, 2, paged)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            _recurrent_tokens(params, cfg, toks, lens, 8, paged)
            torch.cuda.synchronize()
            wall = time.time() - t0
        dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        route = "paged" if paged else "contiguous"
        print(json.dumps(dict(phase="dense_profile", route=route, calls="prefill + 8 steps",
                              wall_s=wall, device_busy_s=dev_us / 1e6)), flush=True)
        avg = prof.key_averages()
        for key in ("cuda_time_total", "self_cpu_time_total"):
            table = avg.table(sort_by=key, row_limit=25)
            tables.append(f"== {route}, by {key}\n{table}")
            print("\n".join(table.splitlines()[:16]), flush=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n\n".join(tables))


def dense_phase(dev, profile_out=None) -> dict:
    """granite-20b (dense, MQA: 48 query heads over 1 KV head, hd 128) at
    published width (d_model 6144, d_ff 24576, vocab 49152) with its depth
    cut to DENSE_LAYERS, bf16 weights from seed 0: 4 right-padded rows (64,
    40, 33 and 57 real tokens) through `prefill_paged` and 16 greedy
    `decode_step_paged` steps (the paged GQA kernel: exactly one launch a
    layer per call, and no other kernel), then the same through `prefill`
    / `decode_step` (plain attention: no kernel). Finite logits are held;
    the two routes' token agreement and largest logit gap are reported
    (bf16: they round differently). Then each dense arch's fp32 smoke
    config with its published G (`keep_groups`), card against CPU from
    the same weights, through both routes: logits within 1e-5 (abs + rel)
    and equal tokens. With `profile_out`, also `profile_dense` into
    <its stem>-granite-20b.txt."""
    t_phase = time.time()
    cfg = get_config(DENSE_ARCH)
    print(f"{DENSE_ARCH}: depth cut {cfg.n_layers} -> {DENSE_LAYERS} layers, every width as "
          f"published", flush=True)
    cfg = dataclasses.replace(cfg, n_layers=DENSE_LAYERS)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    params = init_params(0, cfg, device=dev)
    torch.cuda.synchronize()
    init_s, init_peak_gb = time.time() - t0, torch.cuda.max_memory_allocated(dev) / 1e9
    gen = torch.Generator().manual_seed(8)
    lens = torch.tensor([64, 40, 33, 57], device=dev)
    toks = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen).to(dev)
    for paged in (True, False):  # warm-up: cuBLAS handles, the allocator
        _recurrent_tokens(params, cfg, toks, lens, 1, paged)
    logits, times, launches, per_call = {}, {}, {}, {}
    for paged in (True, False):
        reset_counters()
        calls = []
        torch.cuda.synchronize()
        t0 = time.time()
        logits[paged] = _recurrent_tokens(params, cfg, toks, lens, DENSE_STEPS, paged, calls)
        launches[paged] = read_counters()
        stamps = [t0] + [t for t, _ in calls]
        times[paged] = [b - a for a, b in zip(stamps, stamps[1:])]  # prefill, then steps
        gqa = [0] + [c["paged_prefill_gqa"] for _, c in calls]
        per_call[paged] = [b - a for a, b in zip(gqa, gqa[1:])]
    if per_call[True] != [cfg.n_layers] * (1 + DENSE_STEPS):
        fail(f"{DENSE_ARCH}: paged GQA launches per call {per_call[True]}, not "
             f"{cfg.n_layers} a prefill call and a decode step")
    others = {k: v for k, v in launches[True].items() if k != "paged_prefill_gqa"}
    if any(others.values()) or any(launches[False].values()):
        fail(f"{DENSE_ARCH}: a kernel off the dense path launched: paged {launches[True]}, "
             f"contiguous {launches[False]}")
    for paged, lg in logits.items():
        if lg.shape != (1 + DENSE_STEPS, 4, cfg.vocab_size) or not torch.isfinite(
                lg.float()).all():
            fail(f"{DENSE_ARCH} ({'paged' if paged else 'contiguous'}): logits of shape "
                 f"{tuple(lg.shape)}, or not finite")
    agree = float((logits[True].argmax(-1) == logits[False].argmax(-1)).float().mean())
    gap = float((logits[True].float() - logits[False].float()).abs().max())
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if profile_out:
        out = Path(profile_out)
        profile_dense(params, cfg, toks, lens, out.with_name(f"{out.stem}-{DENSE_ARCH}.txt"))
    # a decode step reads every weight once but the embedding table's
    # (4 of its rows): the least time of a step
    step_bytes = sum(t.numel() * t.element_size() for path, t in leaves_with_path(params)
                     if path[0] != "embed")
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()
    # fp32 smoke, each dense arch at its published G: card against CPU
    worst = {}
    for arch in DENSE_ARCHS:
        scfg = keep_groups(reduce_for_smoke(get_config(arch)), get_config(arch))
        sp = init_params(0, scfg, device="cpu")
        sgen = torch.Generator().manual_seed(9)
        stoks = torch.randint(0, scfg.vocab_size, (4, 16), generator=sgen)
        slens = torch.tensor([16, 9, 12, 5])
        for paged in (True, False):
            got = _recurrent_tokens(_to(sp, dev), scfg, stoks.to(dev), slens.to(dev), 8,
                                    paged).cpu()
            want = _recurrent_tokens(sp, scfg, stoks, slens, 8, paged)
            err = float(((got - want).abs() / (1e-5 + 1e-5 * want.abs())).max())
            route = "paged" if paged else "contiguous"
            worst[f"{arch}/{route}"] = err
            if err > 1 or not torch.equal(got.argmax(-1), want.argmax(-1)):
                fail(f"{arch} fp32 smoke G={scfg.n_heads // scfg.n_kv_heads} ({route}): card "
                     f"logits off the CPU's by {err:.3f} of 1e-5, or other tokens")
    line = dict(
        phase="dense", path=DENSE_PATH, arch=DENSE_ARCH, layers=cfg.n_layers,
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff, dtype=cfg.param_dtype, rows=4,
        decode_steps=DENSE_STEPS, init_s=init_s, init_peak_mem_gb=init_peak_gb,
        peak_mem_gb=peak_gb,
        **{f"{route}_{k}": v for route, t in (("paged", times[True]),
                                              ("contiguous", times[False]))
           for k, v in (("prefill_s", t[0]), ("decode_step_p50_s", float(np.median(t[1:]))),
                        ("decode_step_max_s", max(t[1:])))},
        decode_bound_ms=step_bytes / HBM_BPS * 1e3,
        launches=launches[True], contiguous_launches=launches[False],
        gqa_launches_per_call=per_call[True], tokens_agree=agree, max_logit_gap=gap,
        smoke_fp32_err_over_tol=worst, seconds=time.time() - t_phase)
    print(json.dumps(line), flush=True)
    return line


# ---------------------------------------------------------- entry points
ROOT = Path(__file__).resolve().parent
EXPORT_DIR = ROOT / "profile_out"  # .gitignore'd


# script -> the kernels its path launches on the card (each at least once;
# no other may launch): the smoke serves run paged GQA, the grouped expert
# FFN on prefill chunks and the GEMV tiers on decode steps; the train
# example the flat MoE's moe_gemm; the dense quickstart (plain attention,
# contiguous cache) none
ENTRY_KERNELS = {
    "tools/export_trace_torch.py": ("paged_prefill_gqa", "moe_gemm", "expert_ffn_gemv"),
    "examples/quickstart_torch.py": (),
    "examples/serve_moe_offload_torch.py": ("paged_prefill_gqa", "moe_gemm",
                                            "expert_ffn_gemv"),
    "examples/train_small_moe_torch.py": ("moe_gemm",),
}


def _run_entry(script: str, *argv, counted: bool = True) -> tuple:
    """Run `python script argv...` as its `__main__` block, in this process
    (so the launch counters see it), its standard output captured; fail
    unless it ends with exit status 0. With `counted`, the counters are
    reset just before and must show exactly ENTRY_KERNELS[script] launched.
    Returns (stdout, seconds, launches)."""
    reset_counters()
    buf, argv0, code = io.StringIO(), sys.argv, 0
    sys.argv = [script, *map(str, argv)]
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(ROOT / script), run_name="__main__")
    except SystemExit as e:
        code = e.code
    finally:
        sys.argv = argv0
    torch.cuda.synchronize()
    secs, launches, out = time.time() - t0, read_counters(), buf.getvalue()
    if code not in (0, None):
        fail(f"{script} {' '.join(map(str, argv))} exited {code}:\n{out[-3000:]}")
    if counted:
        want = ENTRY_KERNELS[script]
        if any(launches[k] == 0 for k in want) or any(
                n for k, n in launches.items() if k not in want):
            fail(f"{script}: launches {launches}, want each of {want} and nothing else")
    return out, secs, launches


def export_trace_phase() -> dict:
    """tools/export_trace_torch.py at its defaults on the card, its three
    files into profile_out/: every `kernel.<op>` span must carry backend
    "cuda"; then its `--check` on the trace."""
    script = "tools/export_trace_torch.py"
    EXPORT_DIR.mkdir(exist_ok=True)
    trace = EXPORT_DIR / "serving.trace.json"
    _, secs, launches = _run_entry(script, "--out", trace, "--metrics-json",
                                   EXPORT_DIR / "metrics_snapshot.json", "--prom",
                                   EXPORT_DIR / "metrics_snapshot.prom")
    events = json.loads(trace.read_text())["traceEvents"]
    kernel = [e for e in events if e["name"].startswith("kernel.")]
    backends = {e["args"]["backend"] for e in kernel}
    if not kernel or backends != {"cuda"}:
        fail(f"export_trace: kernel spans with backends {backends} (want cuda only)")
    _, check_s, _ = _run_entry(script, "--check", trace, counted=False)
    snap = json.loads((EXPORT_DIR / "metrics_snapshot.json").read_text())
    line = dict(phase="export_trace", path=script, trace=str(trace.relative_to(ROOT)),
                events=len(events), kernel_spans={n: sum(e["name"] == n for e in kernel)
                                                  for n in sorted({e["name"] for e in kernel})},
                launches=launches, completed=snap["serving.completed"],
                migrations=snap["engine.migrations"], seconds=secs, check_seconds=check_s)
    print(json.dumps(line), flush=True)
    return line


# (script, extra arguments); the train example runs as the JAX example
# does (200 steps of 8 x 64), its checkpoints in a fresh directory
EXAMPLES = (("examples/quickstart_torch.py", ()),
            ("examples/serve_moe_offload_torch.py", ()),
            ("examples/train_small_moe_torch.py", ("--log-every", "50")))


def examples_phase() -> list:
    """The port's three examples on the card (their default device): each
    must exit 0 (the train example only when its loss fell) and launch
    the kernels of its path. One line each."""
    lines = []
    with tempfile.TemporaryDirectory() as ckpt:
        for script, args in EXAMPLES:
            if "train" in script:
                args = (*args, "--ckpt-dir", ckpt)
            out, secs, launches = _run_entry(script, *args)
            outs = out.strip().splitlines()
            lines.append(dict(phase="examples", path=script, args=list(args), seconds=secs,
                              launches=launches, summary=next(
                                  (ln for ln in outs if ln.startswith("[serve] device=")),
                                  outs[-1])))
            print(json.dumps(lines[-1]), flush=True)
    return lines


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
    rounding-sized change of it. The same lr 1e-3 run on the card with
    `moe_backend="ref"` (the plain PyTorch route, no kernel) is reported
    beside it: if its farthest leaves are the kernels' own, the kernels
    are not what moves them. Then the card's state saved as a checkpoint
    and restored on the CPU equals it bitwise."""
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
        runs_of = [("defaults", cfg, AdamWConfig()), ("lr1e-3", cfg, TRAIN_OPT)]
        if d.type == "cuda":
            runs_of.append(("lr1e-3 plain", dataclasses.replace(cfg, moe_backend="ref"),
                            TRAIN_OPT))
        for name, c, opt in runs_of:
            q, o = p, adamw_init(p, opt)
            step = make_train_step(c, opt)
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
    plain_worst = _over(card["lr1e-3 plain"], cpu["lr1e-3"])
    plain_off_grad = _off_grad(card["lr1e-3 plain"], cpu["lr1e-3"], cpu["grads"],
                               plain_worst[0][0])
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
                          lr1e3_plain_route_not_held=dict(
                              worst_leaves=plain_worst[:3],
                              off_elements_grad_over_leaf_max=plain_off_grad),
                          identical_counts=True, checkpoint_restored_bitwise=True,
                          seconds=time.time() - t0)), flush=True)


# ---------------------------------------------------------- distributed
def _to_host(tree):
    return tree_map(lambda t: t.detach().to("cpu"), tree)


def _steps_start(dev) -> int:
    """The bytes allocated as a run of steps starts, the peak counter reset
    to them: the steps' temporaries are the peak less this."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def distributed_phase(dev) -> list:
    """The distributed layer on one card: NCCL at world size 1 (an
    in-process HashStore, no network), the debug mesh (1, 1) of
    launch/mesh.py. granite at published width and full depth trains
    DIST_STEPS steps of the train phase's batches and seed through the
    mesh train step (params and moments stored as DTensors, the kernels
    fed their local tensors), with the launch counters reset just before:
    loss and every param and moment leaf held to the unsharded step's
    (run first, its state then moved to the host) within 1e-6 relative
    (bitwise expected: the kernels see the same tensors), moe_gemm 6
    launches a MoE layer a step and no other kernel. Both run under
    PyTorch's deterministic algorithms (the unsharded step runs twice to
    show its own spread, reported). The mesh state's
    params are saved and restored with `shardings=` bitwise; a raw NCCL
    all-reduce and `compressed_psum` in each method run on a CUDA tensor,
    equal to the quantize round trip. Then one granite MoE layer at the
    train batch through the grouped dispatch with the MoE hints on (its
    32 experts the rank's E/m), counters reset just before, against the
    plain route (bf16 and fp32). The mesh step computes on its shards
    (heads, F, the vocab over "model"; rows over "data"); on one card
    every group is one rank. Reported, not held: each step's median
    seconds, peak memory and temporaries (the allocator's peak less what
    the steps found allocated) for both steps, and, before NCCL starts,
    the dry-run's fake-tensor trace of the train cell at world size 1
    (its temporaries beside the card's). Returns the two paths' launch
    counts."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.collectives import (
        compressed_psum, int8_dequantize, int8_quantize)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.moe import init_moe, moe_forward, set_moe_sharding_hints
    from repro_torch.models.layers import make_generator
    from repro_torch.training import shard_train_state

    t_phase = time.time()
    cfg = get_config(GQA_ARCH)
    t0 = time.time()  # the fake world needs a process with no process group yet
    trace = dryrun.trace_cell(cfg, "train", TRAIN_B, TRAIN_S, {"data": 1, "model": 1})
    trace_s = time.time() - t0
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=dev)
    mesh = make_debug_mesh(device_type="cuda")
    if tuple(mesh.shape) != (1, 1):
        fail(f"{DIST_PATH}: the debug mesh of one card is {tuple(mesh.shape)}, not (1, 1)")
    n_moe = sum(cfg.uses_moe_layer(i) for i in range(cfg.n_layers))
    batches = _batches(cfg, TRAIN_B, TRAIN_S, dev)

    # bf16 index_add (the MoE's combine, index_select's backward) adds in
    # atomics' order on the card, so two runs of one step differ in their
    # roundings: the phase runs PyTorch's deterministic implementations
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)

    def unsharded():
        """DIST_STEPS unsharded steps: (losses, the state on the host, median
        s, peak bytes and temporaries over the steps)."""
        params, opt = init_train_state(0, cfg, TRAIN_OPT, device=dev)
        step = make_train_step(cfg, TRAIN_OPT)
        out, secs = [], []
        base = _steps_start(dev)
        for i in range(DIST_STEPS):
            torch.cuda.synchronize()
            t0 = time.time()
            params, opt, metrics = step(params, opt, batches[i % 2])
            out.append(float(metrics["loss"]))
            secs.append(time.time() - t0)
        peak = torch.cuda.max_memory_allocated(dev)
        state = _to_host({"params": params, "opt": opt})
        del params, opt, metrics
        gc.collect()
        torch.cuda.empty_cache()
        return out, state, sorted(secs[1:])[len(secs[1:]) // 2], peak, peak - base

    # the unsharded step twice (its run-to-run spread), the state waiting on the host
    ref_losses, ref, ref_step_s, ref_peak, ref_temp = unsharded()
    rep_losses, rep, _, _, _ = unsharded()
    repeat_bitwise = rep_losses == ref_losses and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(leaves_with_path(ref), leaves_with_path(rep)))
    del rep

    params, opt = init_train_state(0, cfg, TRAIN_OPT, device=dev)
    params, opt = shard_train_state(params, opt, mesh, cfg)
    step = make_train_step(cfg, TRAIN_OPT, mesh=mesh)
    base = _steps_start(dev)
    reset_counters()
    losses, secs = [], []
    for i in range(DIST_STEPS):
        torch.cuda.synchronize()
        t0 = time.time()
        params, opt, metrics = step(params, opt, batches[i % 2])
        losses.append(float(metrics["loss"]))  # synchronises
        secs.append(time.time() - t0)
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    torch.use_deterministic_algorithms(deterministic)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    if loss_rel > 1e-6:
        fail(f"{DIST_PATH}: mesh losses {losses} off the unsharded step's {ref_losses} "
             f"(its repeat: {rep_losses}, bitwise {repeat_bitwise})")
    if launches["moe_gemm"] != 6 * n_moe * DIST_STEPS:
        fail(f"{DIST_PATH}: moe_gemm launched {launches['moe_gemm']} times, not 6 per MoE "
             f"layer and step: {launches}")
    off = {k: v for k, v in launches.items() if k != "moe_gemm" and v}
    if off:
        fail(f"{DIST_PATH}: kernels off the training path launched: {off}")
    state = {"params": params, "opt": opt}
    want = dict(leaves_with_path(ref))
    worst, bitwise = 0.0, True
    for path, leaf in leaves_with_path(state):
        if not isinstance(leaf, DTensor):
            fail(f"{DIST_PATH}: state leaf {path} is not a DTensor")
        got, w = leaf.to_local(), want[path].to(dev)
        bitwise = bitwise and torch.equal(got, w)
        rel = float((got.float() - w.float()).abs().max() / w.float().abs().max().clamp_min(1e-30))
        worst = max(worst, rel)
    if worst > 1e-6:
        fail(f"{DIST_PATH}: the mesh state is {worst:.3e} (relative) off the unsharded step's")
    del ref, want

    # the mesh params saved whole and restored onto the mesh
    specs = shd.tree_pspecs(params, mesh, cfg)
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as ckpt:
        save(ckpt, DIST_STEPS, params)
        got = restore(ckpt, DIST_STEPS, params, shd.named_shardings(mesh, specs))
    for (path, a), (_, b) in zip(leaves_with_path(got), leaves_with_path(params)):
        if not torch.equal(a.to_local(), b.to_local()) or a.placements != b.placements:
            fail(f"{DIST_PATH}: restored leaf {path} differs")
    del got, params, opt, state
    gc.collect()
    torch.cuda.empty_cache()

    # NCCL on a CUDA tensor: a raw all-reduce, and each compressed method
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(4096, 257, generator=gen).to(dev)
    y = x.clone()
    dist.all_reduce(y)
    if not torch.equal(y, x):
        fail(f"{DIST_PATH}: a world-size-1 NCCL all-reduce changed its input")
    group = dist.group.WORLD
    checks = {"int8": int8_dequantize(*int8_quantize(x)),
              "bf16": x.to(torch.bfloat16).float(), "none": x}
    for method, w in checks.items():
        if not torch.equal(compressed_psum(x, group, method), w):
            fail(f"{DIST_PATH}: compressed_psum({method}) differs from its round trip")

    # one granite MoE layer through the grouped dispatch, hints on
    layer = {}
    for dtype in (torch.bfloat16, torch.float32):
        c = dataclasses.replace(cfg, param_dtype=str(dtype)[6:])
        p = init_moe(make_generator(12, dev), c)
        xin = torch.randn(TRAIN_B, TRAIN_S, cfg.d_model, generator=gen).to(dev, dtype)
        set_moe_sharding_hints(enable=True)
        with shd.use_mesh(mesh), torch.no_grad():
            if dtype == torch.bfloat16:
                reset_counters()
            t0 = time.time()
            out = moe_forward(p, c, xin, grouped=True)
            torch.cuda.synchronize()
            if dtype == torch.bfloat16:
                grouped_s = time.time() - t0
                grouped_launches = read_counters()
            plain = moe_forward(p, c, xin, grouped=True, backend="ref")
        set_moe_sharding_hints(enable=False)
        # bf16: each expert's output within the FFN's roundings (gate|up,
        # SiLU * up, down), then the weighting and the bf16 combine over
        # top-k = 8 assignments, all at the size of the row's RMS
        tol = (grad_rounding_bound(plain.y, LAYER_ROUNDINGS) if dtype == torch.bfloat16
               else None)
        max_abs, _, over = compare(f"{DIST_GROUPED_PATH} layer", out.y, plain.y, dtype, tol)
        if not torch.equal(out.expert_counts, plain.expert_counts):
            fail(f"{DIST_GROUPED_PATH}: expert counts differ from the plain route's")
        layer[str(dtype)[6:]] = dict(max_abs_err=max_abs, err_over_tol=over)
    if grouped_launches["moe_gemm"] != 2 or sum(grouped_launches.values()) != 2:
        fail(f"{DIST_GROUPED_PATH}: launches {grouped_launches}, not moe_gemm's 2 "
             f"(gate|up, down)")
    dist.destroy_process_group()
    step_s = sorted(secs[1:])[len(secs[1:]) // 2]
    print(json.dumps(dict(
        phase="distributed", path=DIST_PATH, arch=GQA_ARCH, mesh=[1, 1], backend="nccl",
        layers=cfg.n_layers, batch=TRAIN_B, seq=TRAIN_S, steps=DIST_STEPS, losses=losses,
        step_s=secs, median_step_s=step_s, tokens_per_s=TRAIN_B * TRAIN_S / step_s,
        peak_mem_gb=peak / 1e9, launches=launches,
        moe_gemm_launches_per_step=launches["moe_gemm"] / DIST_STEPS,
        unsharded_losses=ref_losses, unsharded_median_step_s=ref_step_s,
        mesh_over_unsharded_step_s=step_s / ref_step_s,
        unsharded_peak_mem_gb=ref_peak / 1e9, mesh_over_unsharded_peak=peak / ref_peak,
        trace_memory=dict(
            trace_temp_bytes=trace["memory"]["temp_size_in_bytes"],
            trace_argument_bytes=trace["memory"]["argument_size_in_bytes"],
            card_temp_bytes=peak - base, unsharded_card_temp_bytes=ref_temp,
            trace_over_card=trace["memory"]["temp_size_in_bytes"] / max(peak - base, 1)),
        trace_collectives=trace["collectives"]["counts"], trace_s=trace_s,
        unsharded_repeat_bitwise=repeat_bitwise, deterministic_algorithms=True,
        loss_max_rel_err=loss_rel,
        state_max_rel_err=worst, state_bitwise=bitwise, params_restored_bitwise=True,
        compressed_psum=list(checks), grouped_layer=layer, grouped_layer_s=grouped_s,
        grouped_launches=grouped_launches, seconds=time.time() - t_phase)), flush=True)
    return [dict(path=DIST_PATH, launches=launches),
            dict(path=DIST_GROUPED_PATH, launches=grouped_launches)]


MESH_SERVE_PATH = "mesh_serve"  # granite's tiered prefill + decode on a (1, 1) NCCL mesh
MESH_ROWS, MESH_PROMPT, MESH_STEPS = 8, 64, 16
# jamba at fp32 on the mesh phase: layers 0-4 (Mamba 0-3 with MoE at 1 and
# 3, the attention layer at 4); 8 fp32 layers' draw would not fit the card
JAMBA_MESH_FP32_LAYERS = 5
# each arch of the mesh phase: (path, bf16 depth, fp32 depth; None: the
# published one), in run order
MESH_SERVE_ARCHS = {
    GQA_ARCH: (MESH_SERVE_PATH, None, None),
    JAMBA_ARCH: (MESH_SERVE_PATH + "/jamba", JAMBA_LAYERS, JAMBA_MESH_FP32_LAYERS),
    XLSTM_ARCH: (MESH_SERVE_PATH + "/xlstm", None, None),
    ENCDEC_ARCH: (MESH_SERVE_PATH + "/seamless", None, None),
}


def _mesh_serve_run(params, tiered, cfg, toks, mask, mesh=None, frames=None):
    """A masked prefill of `toks` (through the tiers when given; over the
    encoder's `frames` for an encoder-decoder), then MESH_STEPS greedy
    decode steps (on `mesh`: the mesh path, params and tiers DTensors).
    Returns (tokens [steps, B], logits [steps + 1, B, V] on the host, each
    decode step's seconds and GEMV launches, the prefill's launches, the
    card's step temporaries {"prefill", "decode"} in bytes)."""
    lens = mask.sum(-1).to(torch.int32)
    cache_len = MESH_PROMPT + MESH_STEPS
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    logits, cache = prefill(params, cfg, toks, cache_len, tiered=tiered, token_mask=mask,
                            frames=frames, mesh=mesh)
    torch.cuda.synchronize()
    prefill_launches = read_counters()
    temp = {"prefill": torch.cuda.max_memory_allocated() - base, "decode": 0}
    out_logits, out_toks, secs, gemv = [logits.float().cpu()], [], [], []
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    for step in range(MESH_STEPS):
        out_toks.append(tok[:, 0].cpu())
        torch.cuda.synchronize()
        before, n0 = torch.cuda.memory_allocated(), expert_ffn_gemv.launches
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        logits, cache, _ = decode_step(params, cfg, tok, cache, lens + step, tiered=tiered,
                                       mesh=mesh)
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
        temp["decode"] = max(temp["decode"], torch.cuda.max_memory_allocated() - before)
        gemv.append(expert_ffn_gemv.launches - n0)
        out_logits.append(logits.float().cpu())
        tok = logits.argmax(-1)[:, None].to(torch.int32)
    return (torch.stack(out_toks), torch.stack(out_logits), secs, gemv, prefill_launches,
            temp)


def _mesh_cfg(pub, dtype, layers):
    cfg = dataclasses.replace(pub, param_dtype=str(dtype)[6:])
    return cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)


def _mesh_serve_arch(dev, mesh, arch, sizes, toks, mask) -> dict:
    """One arch of `mesh_serve_phase`: fp32 then bf16, the unsharded path
    then the mesh path on the same storage (on a (1, 1) mesh every spec is
    replicated, so the DTensors wrap the unsharded tensors), each run's
    logits kept on the host. Returns the arch's report; its "launches" are
    the bf16 mesh run's (the counters reset just before it), its peak the
    card's largest allocation: each dtype's setup (params drawn, experts
    copied into tiers) or a step of its runs."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.layers import make_generator, torch_dtype
    from repro_torch.serving.engine import strip_expert_weights

    path, bf16_layers, fp32_layers = MESH_SERVE_ARCHS[arch]
    pub = get_config(arch)
    out, peak = {}, 0
    for dtype, layers in ((torch.float32, fp32_layers), (torch.bfloat16, bf16_layers)):
        cfg = _mesh_cfg(pub, dtype, layers)
        torch.cuda.reset_peak_memory_stats()
        params = init_params(0, cfg, device=dev)
        tiered = None
        if sizes is not None:
            tiered = fill_tiers_from_params(params, init_tiered_for_model(
                make_generator(1, dev), cfg, sizes, mesh=mesh), cfg)
            params = strip_expert_weights(params, cfg)
        frames = (None if cfg.encdec is None
                  else _frames(cfg, toks.shape[0], 22, torch_dtype(cfg.param_dtype), dev))
        setup_peak = torch.cuda.max_memory_allocated()  # the runs reset the peak
        with torch.no_grad():
            plain = _mesh_serve_run(params, tiered, cfg, toks, mask, frames=frames)
            on_mesh = _mesh_serve_run(
                shd.shard_tree(params, mesh, shd.tree_pspecs(params, mesh, cfg)),
                None if tiered is None else shd.shard_tiered(tiered, mesh), cfg, toks, mask,
                mesh, frames)
        launches = read_counters()  # the bf16 mesh run is the path's
        peak = max(peak, setup_peak, torch.cuda.max_memory_allocated())
        rel = float((on_mesh[1] - plain[1]).abs().max() / plain[1].abs().max())
        same = bool(torch.equal(on_mesh[0], plain[0]))
        if not bool(torch.isfinite(on_mesh[1]).all()):
            fail(f"{path}: non-finite {dtype} logits on the mesh path")
        if dtype == torch.float32 and (not same or rel > 1e-5):
            fail(f"{path}: fp32 mesh tokens equal {same}, logits {rel:.3e} (relative) off "
                 "the unsharded path's")
        n_moe = sum(cfg.uses_moe_layer(i) for i in range(cfg.n_layers)) if cfg.moe else 0
        for name, run in (("unsharded", plain), ("mesh", on_mesh)):
            if sizes is None and (any(run[4].values()) or any(run[3])):
                fail(f"{path}: a kernel launched on the {name} {dtype} path: {run[4]}, GEMV "
                     f"{run[3]} (no Pallas kernel reaches this arch in the reference)")
            if sizes is not None and set(run[3]) != {3 * n_moe}:
                fail(f"{path}: {name} {dtype} GEMV launches a step {run[3]}, not {3 * n_moe}")
        if sizes is not None and (on_mesh[4] != plain[4] or on_mesh[4]["moe_gemm"] != 6 * n_moe):
            fail(f"{path}: prefill launches {on_mesh[4]} (unsharded {plain[4]}), not "
                 f"moe_gemm's {6 * n_moe} (2 a tier a layer)")
        out[str(dtype)[6:]] = dict(
            layers=cfg.n_layers, setup_peak_gb=setup_peak / 1e9, tokens_equal=same,
            logits_max_rel_err=rel,
            token_agreement=float((on_mesh[0] == plain[0]).float().mean()),
            decode_p50_ms=float(np.median(on_mesh[2]) * 1e3),
            unsharded_decode_p50_ms=float(np.median(plain[2]) * 1e3),
            gemv_launches_per_step=on_mesh[3][0], prefill_launches=on_mesh[4],
            step_temp_bytes=on_mesh[5], unsharded_step_temp_bytes=plain[5])
        del params, tiered, plain, on_mesh, frames
        gc.collect()
        torch.cuda.empty_cache()
    return dict(path=path, launches=launches, by_dtype=out, peak_mem_gb=peak / 1e9)


def mesh_serve_phase(dev) -> list:
    """The serving functions' mesh path on one card, arch by arch
    (MESH_SERVE_ARCHS), a masked prefill of MESH_ROWS rows of MESH_PROMPT
    slots and MESH_STEPS greedy decode steps through the unsharded
    `prefill` / `decode_step` and through `prefill(..., mesh=)` /
    `decode_step(..., mesh=)` on a (1, 1) NCCL mesh (params and tiers
    DTensors; every spec replicated there, so each tier runs whole on the
    rank, and the DP and "model" collectives run on one-rank groups):
    - granite-moe-1b-a400m at published width and full depth (24 layers),
      tiers as the serve phases size them (8 hot, 10 warm, 14 cold);
    - jamba-v0.1-52b at full width, 8 layers (one Jamba block: Mamba
      channel-parallel, the attention layer at 4, MoE at 1 / 3 / 5 / 7)
      in bf16, 5 at fp32, tiers (4, 5, 7);
    - xlstm-125m and seamless-m4t-large-v2 (the encoder over [8, 1024,
      1024] frames) at full width and depth.
    fp32: the mesh path's tokens identical to the unsharded path's, its
    logits within 1e-5 of their largest. bf16: a tiered arch's GEMV at 3 a
    MoE layer a step (granite 72, jamba 12) and moe_gemm's prefill
    launches 6 a MoE layer (granite 144, jamba 24) on both paths; xlstm and
    seamless launch none of the five kernels; each path's decode-step p50;
    the counters reset just before the bf16 mesh run are the path's
    launches. Before NCCL starts, the dry-run's fake-tensor trace of each
    bf16 cell at world size 1 (a one-rank fake world, the kernels as their
    launches): its step temporaries beside the card's (the allocator's
    peak above what the step found allocated)."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.serving.tiered_moe import tier_sizes

    t_phase = time.time()
    sizes = {GQA_ARCH: tier_sizes(get_config(GQA_ARCH)),
             JAMBA_ARCH: ARCH_LOOP_KW[JAMBA_ARCH]["sizes"], XLSTM_ARCH: None, ENCDEC_ARCH: None}
    if tuple(sizes[GQA_ARCH]) != (8, 10, 14):
        fail(f"{MESH_SERVE_PATH}: granite's tiers are {tuple(sizes[GQA_ARCH])}, not the serve "
             "phases' (8, 10, 14)")
    one = {"data": 1, "model": 1}
    trace, trace_s = {}, {}
    for arch, (_, layers, _) in MESH_SERVE_ARCHS.items():
        t0 = time.time()
        cfg = _mesh_cfg(get_config(arch), torch.bfloat16, layers)
        trace[arch] = {
            "prefill": dryrun.trace_cell(cfg, "prefill", MESH_ROWS, MESH_PROMPT, one,
                                         sizes=sizes[arch], tiered_prefill=True,
                                         cache_len=MESH_PROMPT + MESH_STEPS, pad_cold_to=1),
            "decode": dryrun.trace_cell(cfg, "decode", MESH_ROWS, MESH_PROMPT + MESH_STEPS, one,
                                        sizes=sizes[arch], pad_cold_to=1)}
        trace_s[arch] = time.time() - t0
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=dev)
    mesh = make_debug_mesh(device_type="cuda")
    paths = []
    for arch, (path, _, _) in MESH_SERVE_ARCHS.items():
        t_arch = time.time()
        vocab = get_config(arch).vocab_size
        gen = torch.Generator().manual_seed(21)
        toks = torch.randint(0, vocab, (MESH_ROWS, MESH_PROMPT), generator=gen).to(dev)
        lens = torch.randint(MESH_PROMPT // 2, MESH_PROMPT + 1, (MESH_ROWS,), generator=gen)
        mask = (torch.arange(MESH_PROMPT)[None, :] < lens[:, None]).to(dev)
        rep = _mesh_serve_arch(dev, mesh, arch, sizes[arch], toks, mask)
        measured = rep["by_dtype"]["bfloat16"]["step_temp_bytes"]
        tr = trace[arch]
        mem = {k: dict(trace_temp_bytes=tr[k]["memory"]["temp_size_in_bytes"],
                       trace_argument_bytes=tr[k]["memory"]["argument_size_in_bytes"],
                       card_temp_bytes=measured[k],
                       trace_over_card=tr[k]["memory"]["temp_size_in_bytes"]
                       / max(measured[k], 1))
               for k in ("prefill", "decode")}
        print(json.dumps(dict(
            phase="mesh_serve", path=path, arch=arch, mesh=[1, 1], backend="nccl",
            rows=MESH_ROWS, prompt=MESH_PROMPT, steps=MESH_STEPS,
            tiers=None if sizes[arch] is None else list(sizes[arch]),
            launches=rep["launches"], by_dtype=rep["by_dtype"], peak_mem_gb=rep["peak_mem_gb"],
            trace_memory=mem, trace_collectives={k: tr[k]["collectives"]["counts"] for k in tr},
            trace_s=trace_s[arch], seconds=time.time() - t_arch)), flush=True)
        paths.append(dict(path=path, launches=rep["launches"]))
    dist.destroy_process_group()
    print(json.dumps(dict(phase="mesh_serve", archs=list(MESH_SERVE_ARCHS),
                          seconds=time.time() - t_phase)), flush=True)
    return paths


# ------------------------------------------------------ encoder-decoder
def _frames(cfg, b: int, seed: int, dtype, dev) -> torch.Tensor:
    """Seeded encoder frames [b, F, D], 0.02 N(0, 1) as `add_frames`
    makes them, in `dtype` (the params': the model refuses a mix)."""
    gen = torch.Generator().manual_seed(seed)
    f = torch.randn((b, cfg.encdec.frontend_frames, cfg.d_model), generator=gen) * 0.02
    return f.to(device=dev, dtype=dtype)


def _encdec_generate(params, cfg, toks, lens, frames, steps: int):
    """Masked prefill of right-padded rows over the encoder's frames, then
    `steps` greedy decode steps at each row's own position. Returns (the
    logits of every step, stacked [steps + 1, B, V], the cache, the
    prefill's seconds, each decode step's seconds), each timed to a
    device synchronisation."""
    s = toks.shape[1]
    mask = torch.arange(s, device=toks.device)[None, :] < lens[:, None]
    t0 = time.time()
    logits, cache = prefill(params, cfg, toks, cache_len=s + steps, token_mask=mask,
                            frames=frames)
    torch.cuda.synchronize()
    prefill_s = time.time() - t0
    out, pos, step_s = [logits], lens.to(torch.int32), []
    for _ in range(steps):
        t0 = time.time()
        nxt = out[-1].argmax(-1).to(torch.int32)[:, None]
        logits, cache, _ = decode_step(params, cfg, nxt, cache, pos)
        out.append(logits)
        pos = pos + 1
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
    return torch.stack(out), cache, prefill_s, step_s


def seamless_phase(dev) -> dict:
    """seamless-m4t-large-v2 at full width and depth (24 encoder and 24
    decoder layers, d_model 1024, 16 heads, d_ff 8192, vocab 256206),
    bf16 weights from seed 0, at the model level (the reference's loop
    serves routed-MoE models only): the encoder over frames [4, 1024,
    1024], a masked prefill of 4 right-padded rows of 64 slots (64, 40, 33
    and 57 real tokens) storing every decoder layer's cross K/V, then 16
    greedy decode steps reading them, with the launch counters reset just
    before: none of the five kernels may launch (the reference's encoder
    and cross attention are plain jnp). Reported: the relative error of
    prefill(64) + one decode step against `forward_train` at position 64
    (the reference's own property, tests/test_models.py, which holds it
    to 0.03 at smoke size). Then the fp32 smoke config on the card and
    on the CPU from the same weights and frames: `forward_train` logits
    and every generate step's logits within 1e-5 (abs + rel), equal
    tokens."""
    t_phase = time.time()
    cfg = get_config(ENCDEC_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(0, cfg, device=dev)
    dt = params["embed"]["table"].dtype
    frames = _frames(cfg, 4, 7, dt, dev)
    gen = torch.Generator().manual_seed(8)
    lens = torch.tensor([64, 40, 33, 57], device=dev)
    toks = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen).to(dev)
    torch.cuda.synchronize()
    setup_s = time.time() - t_phase
    setup_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    reset_counters()
    with torch.no_grad():
        out, cache, prefill_s, step_s = _encdec_generate(params, cfg, toks, lens, frames, 16)
        launches = read_counters()
        # the reference's property: prefill(S) + decode(token S) vs the full forward
        l2, c2 = prefill(params, cfg, toks, cache_len=65, frames=frames)
        nxt = l2.argmax(-1).to(torch.int32)[:, None]
        step, _, _ = decode_step(params, cfg, nxt, c2, 64)
        full, _, _ = forward_train(params, cfg, {"tokens": torch.cat([toks, nxt], 1),
                                                 "frames": frames})
        ref = full[:, 64].float()
        rel = float((step.float() - ref).abs().max() / (ref.abs().max() + 1e-9))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if any(launches.values()):
        fail(f"{ENCDEC_ARCH}: a kernel launched on the encoder-decoder path: {launches}")
    if out.shape != (17, 4, cfg.vocab_size) or not torch.isfinite(out.float()).all():
        fail(f"{ENCDEC_ARCH}: logits of shape {tuple(out.shape)}, or not finite")
    if cache["stack"]["slot0"]["ck"].shape != (cfg.n_layers, 4, 1024, cfg.n_kv_heads,
                                               cfg.resolved_head_dim):
        fail(f"{ENCDEC_ARCH}: cross K/V cache of shape "
             f"{tuple(cache['stack']['slot0']['ck'].shape)}")
    del params, cache, c2, full, out
    # fp32 smoke: the card against the CPU, same weights and inputs
    scfg = dataclasses.replace(reduce_for_smoke(cfg), param_dtype="float32",
                               compute_dtype="float32")
    sp = init_params(0, scfg, device="cpu")
    stoks = torch.randint(0, scfg.vocab_size, (4, 16), generator=gen)
    slens = torch.tensor([16, 9, 12, 5])
    sframes = _frames(scfg, 4, 9, torch.float32, "cpu")
    with torch.no_grad():
        got = [_encdec_generate(_to(sp, dev), scfg, stoks.to(dev), slens.to(dev),
                                sframes.to(dev), 8)[0].cpu(),
               forward_train(_to(sp, dev), scfg, {"tokens": stoks.to(dev),
                                                  "frames": sframes.to(dev)})[0].cpu()]
        want = [_encdec_generate(sp, scfg, stoks, slens, sframes, 8)[0],
                forward_train(sp, scfg, {"tokens": stoks, "frames": sframes})[0]]
    worst = max(float(((g - w).abs() / (1e-5 + 1e-5 * w.abs())).max())
                for g, w in zip(got, want))
    if not torch.equal(got[0].argmax(-1), want[0].argmax(-1)) or worst > 1:
        fail(f"{ENCDEC_ARCH} fp32 smoke: card logits off the CPU's by {worst:.3f} of 1e-5, "
             f"or other tokens")
    print(json.dumps(dict(
        phase="seamless", path=SEAMLESS_PATH, arch=ENCDEC_ARCH, layers=cfg.n_layers,
        encoder_layers=cfg.encdec.n_encoder_layers, d_model=cfg.d_model,
        frames=cfg.encdec.frontend_frames, dtype=cfg.param_dtype, rows=4, decode_steps=16,
        setup_s=setup_s, setup_peak_gb=setup_gb, prefill_s=prefill_s, decode_s=sum(step_s),
        decode_step_s=step_s, median_decode_step_s=sorted(step_s)[len(step_s) // 2],
        peak_mem_gb=peak_gb, decode_vs_forward_rel_err=rel, launches=launches,
        smoke_fp32_err_over_tol=worst, identical_smoke_tokens=True,
        seconds=time.time() - t_phase)), flush=True)
    return dict(path=SEAMLESS_PATH, launches=launches)


def seamless_train_phase(dev) -> dict:
    """seamless-m4t-large-v2 at full width and depth trained for
    SEAMLESS_TRAIN_STEPS steps of 4 x 256 tokens from `SyntheticCorpus`
    (batches i % 2) with `add_frames`' frames (fp32, cast to the params'
    bf16 as launch/train.py casts them), AdamW as the train phase runs it
    (lr 1e-3, 2 warm-up steps), each decoder layer group and encoder
    layer checkpointed, the launch counters reset just before: every
    loss finite, the last below the first, no kernel launched. Step time:
    the median after the first 2 steps."""
    t_phase = time.time()
    cfg = get_config(ENCDEC_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    params, opt = init_train_state(0, cfg, TRAIN_OPT, device=dev)
    dt = params["embed"]["table"].dtype
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    batches = []
    for i in range(2):
        b = add_frames(corpus.batch(i, SEAMLESS_TRAIN_B, SEAMLESS_TRAIN_S), cfg)
        b = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        b["frames"] = b["frames"].to(dt)
        batches.append(b)
    step = make_train_step(cfg, TRAIN_OPT)
    torch.cuda.synchronize()
    setup_s = time.time() - t_phase
    reset_counters()
    losses, secs = [], []
    for i in range(SEAMLESS_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.time()
        params, opt, metrics = step(params, opt, batches[i % 2])
        losses.append(float(metrics["loss"]))  # synchronises
        secs.append(time.time() - t0)
    launches = read_counters()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"{SEAMLESS_TRAIN_PATH}: losses {losses} are not finite and falling")
    if any(launches.values()):
        fail(f"{SEAMLESS_TRAIN_PATH}: a kernel launched on the encoder-decoder path: "
             f"{launches}")
    timed = sorted(secs[2:])
    step_s = timed[len(timed) // 2]
    print(json.dumps(dict(
        phase="seamless_train", path=SEAMLESS_TRAIN_PATH, arch=ENCDEC_ARCH,
        layers=cfg.n_layers, encoder_layers=cfg.encdec.n_encoder_layers,
        d_model=cfg.d_model, dtype=cfg.param_dtype, batch=SEAMLESS_TRAIN_B,
        seq=SEAMLESS_TRAIN_S, frames=cfg.encdec.frontend_frames, steps=SEAMLESS_TRAIN_STEPS,
        losses=losses, step_s=secs, median_step_s=step_s,
        tokens_per_s=SEAMLESS_TRAIN_B * SEAMLESS_TRAIN_S / step_s,
        frames_per_s=SEAMLESS_TRAIN_B * cfg.encdec.frontend_frames / step_s,
        peak_mem_gb=peak_gb, setup_s=setup_s, launches=launches,
        seconds=time.time() - t_phase)), flush=True)
    return dict(path=SEAMLESS_TRAIN_PATH, launches=launches)


# the phases in their order; `--only` runs a subset of them
PHASES = ("kernels", "mha", "mamba", "xlstm", "gradient", "train", "train_smoke_parity",
          "distributed", "mesh_serve", "seamless", "seamless_train", "dense", "serve", "spec_fp32",
          "smoke_parity", "export_trace", "examples")


def _cleared() -> None:
    gc.collect()
    torch.cuda.empty_cache()  # a phase's weights and tiers, before the next one


def kernels_line(rows, by_label, paths, dx) -> dict:
    """The `kernels` JSON line: each kernel's first row, with its launches
    on the path it was ported on and on every path; paged_prefill_gqa's
    dense-family rows, moe_gemm's train-step dX and grouped-dispatch rows,
    and the smoke-width rows of the entry points' kernels beside those
    paths' launches."""
    by_path = {p["path"]: p["launches"] for p in paths}  # each after its own reset
    dense_calls = next(p for p in paths if p["path"] == DENSE_PATH)["gqa_launches_per_call"]
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
        if name == "paged_prefill_gqa":
            # the dense family's (Kv, G) pairs at hd 128; only two of the
            # shapes run on a full-width path (the dense phase's calls)
            dense = {}
            for label in DENSE_LABELS:
                calls = dense_calls[DENSE_ROW_CALLS[label]] if label in DENSE_ROW_CALLS else []
                dense[label] = dict(
                    launches=sum(calls), launches_per_call=calls,
                    path=DENSE_PATH if calls else None,
                    **{k: by_label[label][k] for k in ("max_abs_err", "err_over_tol",
                                                        "kernel_ms", "plain_ms", "bound_ms",
                                                        "bound_by", "library_ms")})
            kernels[-1]["dense"] = dense
        smoke = [label for kname, label in SMOKE_LABELS if kname == name]
        if smoke:  # the entry points' smoke-width shapes, and those paths' launches
            kernels[-1]["smoke"] = dict(
                launches_by_path={p: by_path[p][name] for p in ENTRY_KERNELS},
                rows={label: {k: by_label[label][k] for k in (
                    "max_abs_err", "err_over_tol", "kernel_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")} for label in smoke})
        if name == "moe_gemm":  # the dX products of the train step's backward
            kernels[-1]["train_dx"] = dx
            # the grouped dispatch's two GEMMs under the MoE hints, each
            # launched once by the distributed/grouped path's layer
            kernels[-1]["grouped_dispatch"] = {
                label: dict(launches=by_path[DIST_GROUPED_PATH][name] // 2,
                            **{k: by_label[label][k] for k in (
                                "max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")})
                for label in (GROUPED_GU, GROUPED_DOWN)}
    return {"kernels": kernels}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also trace a serving window with torch.profiler")
    ap.add_argument("--profile-out", default="profile_out/serve_profile.txt",
                    help="where --profile writes its full tables (one per model: "
                         "the file name's stem gets -<arch>)")
    ap.add_argument("--only", default=None,
                    help=f"comma-separated phases to run, of {', '.join(PHASES)} (default: "
                         "all, then the kernels line); the build and SASS check always run")
    ap.add_argument("--cases", default=None,
                    help="comma-separated words: the kernels phase runs only the rows "
                         "whose label holds one of them")
    args = ap.parse_args(argv)
    run = PHASES if args.only is None else tuple(args.only.split(","))
    if set(run) - set(PHASES):
        ap.error(f"unknown phases {sorted(set(run) - set(PHASES))}; phases: {PHASES}")
    profile_out = args.profile_out if args.profile else None
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

    paths, dx, train_paths = [], {}, []
    rows, by_label = {}, {}
    if "kernels" in run:
        words = args.cases.split(",") if args.cases else None
        rows, by_label = kernel_phases(dev, words)
    if "mha" in run:
        paths.append(mha_entry(dev))
    if "mamba" in run:
        mamba_phase(dev)
    if "xlstm" in run:
        xlstm_phase(dev)
    if "gradient" in run:
        dx = grad_phase(dev)
    if "train" in run:
        train_paths = train_phase(dev, profile_out=profile_out)
        paths += train_paths
        for row in dx.values():  # each dX product runs once a MoE layer a step
            row["launches_per_step"] = (train_paths[0]["launches"]["moe_gemm"]
                                        // (6 * TRAIN_STEPS))
    if "train_smoke_parity" in run:
        train_smoke_parity(dev)
    _cleared()
    if "distributed" in run:
        paths += distributed_phase(dev)
        _cleared()
    if "mesh_serve" in run:
        paths += mesh_serve_phase(dev)
        _cleared()
    for name, phase in (("seamless", seamless_phase), ("seamless_train", seamless_train_phase),
                        ("dense", lambda d: dense_phase(d, profile_out))):
        if name in run:
            paths.append(phase(dev))
            _cleared()
    if "serve" in run:
        for arch, n_layers, mode, expect, forbid in SERVES:
            paths.append(serve_full(dev, arch, n_layers, mode, expect, forbid,
                                    profile_out=profile_out,
                                    plain_tokens=next((p["tokens"] for p in paths
                                                       if p["path"] == arch), None)))
            _cleared()
    if "spec_fp32" in run:
        spec_fp32_full(dev)
        _cleared()
    if "smoke_parity" in run:
        for arch in (GQA_ARCH, MLA_ARCH):
            plain = serve_smoke_parity(dev, arch)
            for mode in MODES:
                serve_smoke_parity(dev, arch, mode, plain)
            replay_parity(dev, arch)
        for mode in (None, "slots"):  # jamba: the paged default admits whole suffixes
            serve_smoke_parity(dev, JAMBA_ARCH, mode)
    if "export_trace" in run:
        paths.append(export_trace_phase())
    if "examples" in run:
        paths += examples_phase()

    if args.only is None:
        print(json.dumps(kernels_line(rows, by_label, paths, dx)), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
