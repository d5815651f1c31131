"""Config system: architecture configs + input-shape specs.

Every assigned architecture gets a module ``configs/<id>.py`` exporting a
``CONFIG: ModelConfig`` built with the exact published numbers, plus a
``reduced()`` smoke-test variant of the same family (small widths / few
experts / tiny vocab) that runs a real forward/train step on one CPU device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import TYPE_CHECKING, Optional, Sequence

if TYPE_CHECKING:  # runtime import would cycle configs <-> core
    from repro_torch.core.policy import SchedulerPolicy
    from repro_torch.obs import ObsConfig


@dataclass(frozen=True)
class MoEConfig:
    """Routed-expert block config (the paper's subject)."""

    n_experts: int  # routed experts
    top_k: int
    d_expert: int  # per-expert FFN hidden dim
    n_shared: int = 0  # shared (always-hot) experts
    # layers that use MoE instead of dense FFN; "every" / "every_2" / "all_but_first"
    layer_pattern: str = "all"
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25  # training dispatch capacity
    # serving tier sizing (TriMoE): slots per tier; scheduler fills them.
    n_hot_slots: int = 0  # 0 => n_shared + max(1, n_experts // 16)
    n_warm_frac: float = 0.30  # paper §3.1: ~30% warm
    # "first_k_dense" pattern: dense FFN in layers [0, first_k_dense)
    first_k_dense: int = 1
    # routing: "softmax" (softmax, top-k, renormalized) or "noaux_tc"
    # (DeepSeek-V3: sigmoid scores; the top-k of score + bias within the
    # `topk_group` best of `n_group` groups, a group scored by its two
    # highest; weights the unbiased scores renormalized, times routed_scale)
    router: str = "softmax"
    n_group: int = 1
    topk_group: int = 1
    routed_scale: float = 1.0
    # the share of an expert-parallel layer held here: experts
    # [held_from, held_from + n_experts) of `n_routed` the router scores
    # (0 => n_experts: every expert held). Assignments to experts held
    # elsewhere are not dispatched, weighted or counted.
    n_routed: int = 0
    held_from: int = 0

    @property
    def routed(self) -> int:
        """The router's width: every routed expert of the layer."""
        return self.n_routed or self.n_experts

    @property
    def holds_share(self) -> bool:
        return self.routed != self.n_experts


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int = 0  # 0 => direct q projection; else wq_a, RMSNorm, wq_b
    kv_norm: bool = False  # RMSNorm on the KV latent before it is cached
    yarn: Optional["YarnScaling"] = None  # None => plain RoPE


@dataclass(frozen=True)
class YarnScaling:
    """YaRN rope scaling (DeepSeek-V2/V3's `rope_scaling` of type "yarn"):
    frequencies ramped between interpolated (/ factor) and extrapolated
    ones over the dims whose rotations at the original context lie
    between `beta_slow` and `beta_fast`; the softmax scale times
    mscale(factor, mscale_all_dim)^2, cos / sin times
    mscale(factor, mscale) / mscale(factor, mscale_all_dim)."""

    factor: float = 40.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 1.0


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 => ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMConfig:
    # block pattern: 's' = sLSTM block, 'm' = mLSTM block, tiled over layers
    pattern: str = "msmsmsmsmsms"
    proj_factor_m: float = 2.0  # mLSTM up-projection
    proj_factor_s: float = 1.333  # sLSTM FFN factor


@dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 24
    cross_attention: bool = True
    # frontend stub: precomputed frame/patch embeddings fed to the encoder
    frontend_frames: int = 1024  # encoder source length for dry-run shapes
    frontend_dim: int = 0  # 0 => d_model


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // n_heads
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encdec: Optional[EncDecConfig] = None
    # hybrid (jamba): attention every `attn_every` layers, Mamba otherwise
    attn_every: int = 0  # 0 => all layers attention
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    qkv_bias: bool = False  # qwen2.5
    # dtype policy
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # attention contract: can this arch serve 500k+ contexts?
    subquadratic: bool = False
    # kernel-backend knobs, one per kernel family, all resolved through
    # the shared repro_torch.kernels.backend.resolve_backend rule:
    # "auto" = the hand-written CUDA kernel for a CUDA tensor, the plain
    # PyTorch version for a CPU tensor; "cuda" forces the kernel (a CPU
    # tensor raises); "ref" forces the plain version.
    #
    # paged decode/prefill attention (serving, kernels/paged_attention):
    # ref = the dense-gather path.
    paged_attn_backend: str = "auto"
    # routed-expert FFN (models/moe.py + serving/tiered_moe.py):
    # cuda = grouped MoE GEMM (kernels/moe_gemm) for prefill buffers,
    # batched expert GEMV (kernels/expert_gemv) for decode buffers;
    # ref = their plain PyTorch versions.
    moe_backend: str = "auto"
    # online tier-scheduling policy (core/policy.SchedulerPolicy); None =
    # library defaults. Resolved by repro_torch.core.policy.resolve_policy with
    # the same precedence rule as the kernel-backend knobs above:
    # explicit ServingLoop(scheduler=...) > cfg.scheduler > defaults.
    scheduler: Optional["SchedulerPolicy"] = None
    # observability knobs (repro_torch.obs.ObsConfig); None = metrics on,
    # tracing off. Resolved by repro_torch.obs.resolve_obs with the same
    # precedence rule: explicit ServingLoop(obs=...) > cfg.obs >
    # defaults (pass a live repro_torch.obs.Observability via the kwarg to
    # share one registry/tracer across components).
    obs: Optional["ObsConfig"] = None

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs are decoder-bearing

    def uses_moe_layer(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        p = self.moe.layer_pattern
        if p == "all":
            return True
        if p == "every_2":
            return layer_idx % 2 == 1
        if p == "all_but_first":
            return layer_idx > 0
        if p == "first_k_dense":
            return layer_idx >= self.moe.first_k_dense
        raise ValueError(f"unknown moe layer_pattern {p!r}")

    def uses_attention_layer(self, layer_idx: int) -> bool:
        if self.family == "ssm" and self.xlstm is not None:
            return False  # xLSTM handles mixing itself
        if self.attn_every <= 1:
            return True
        # jamba: 1 attention layer per `attn_every` block, at slot attn_every//2
        return layer_idx % self.attn_every == self.attn_every // 2

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d  # lm head
        hd = self.resolved_head_dim
        for i in range(self.n_layers):
            # --- mixer ---
            if self.family == "ssm" and self.xlstm is not None:
                total += _xlstm_block_params(self, i)
            elif self.uses_attention_layer(i):
                if self.mla is not None:
                    m = self.mla
                    qd = self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    if m.q_lora_rank:  # q_a, its norm, q_b
                        total += d * m.q_lora_rank + m.q_lora_rank + m.q_lora_rank * qd
                    else:
                        total += d * qd  # q
                    total += d * (m.kv_lora_rank + m.qk_rope_head_dim)  # kv_a
                    total += m.kv_lora_rank * self.n_heads * (
                        m.qk_nope_head_dim + m.v_head_dim
                    )  # kv_b
                    total += self.n_heads * m.v_head_dim * d  # o
                    if m.kv_norm:
                        total += m.kv_lora_rank
                else:
                    total += d * self.n_heads * hd  # q
                    total += 2 * d * self.n_kv_heads * hd  # k,v
                    total += self.n_heads * hd * d  # o
            else:  # mamba
                mc = self.mamba or MambaConfig()
                d_inner = int(mc.expand * d)
                dt_rank = mc.dt_rank or -(-d // 16)
                total += d * 2 * d_inner  # in_proj
                total += d_inner * mc.d_conv  # conv
                total += d_inner * (dt_rank + 2 * mc.d_state)  # x_proj
                total += dt_rank * d_inner  # dt_proj
                total += d_inner * mc.d_state  # A (log)
                total += d_inner * d  # out_proj
            # --- FFN / MoE ---
            if self.family == "ssm" and self.xlstm is not None:
                pass  # included in block params
            elif self.uses_moe_layer(i):
                mo = self.moe
                per_exp = 3 * d * mo.d_expert
                total += (mo.n_experts + mo.n_shared) * per_exp
                total += d * mo.routed  # router
            else:
                if self.d_ff > 0:
                    total += 3 * d * self.d_ff  # SwiGLU
            total += 2 * d  # norms
        if self.encdec is not None:
            e = self.encdec
            for _ in range(e.n_encoder_layers):
                total += 4 * d * self.n_heads * hd * 0 + (
                    d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                    + self.n_heads * hd * d + 3 * d * self.d_ff + 2 * d
                )
            # decoder cross-attention extra
            total += self.n_layers * (
                d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d + d
            )
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        n_moe_layers = sum(self.uses_moe_layer(i) for i in range(self.n_layers))
        inactive = (mo.n_experts - mo.top_k) * 3 * self.d_model * mo.d_expert
        return self.param_count() - n_moe_layers * inactive


def _xlstm_block_params(cfg: ModelConfig, i: int) -> int:
    x = cfg.xlstm
    d = cfg.d_model
    kind = x.pattern[i % len(x.pattern)]
    if kind == "m":
        di = int(x.proj_factor_m * d)
        # up/gate proj, qkv inside, out proj
        return 2 * d * di + 3 * di * di // max(cfg.n_heads, 1) + di * d + 4 * di
    else:
        di = d
        # recurrent gates (i,f,z,o) input+recurrent + FFN
        return 8 * d * di + int(2 * x.proj_factor_s * d * d)


# ----------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES: Sequence[ShapeSpec] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def refuse_on_mesh(cfg: ModelConfig, what: str) -> None:
    """The mesh paths run MLA with a direct q projection, no latent norm
    and plain RoPE, and the softmax router over every expert held: raise
    for any other configuration before `what` computes anything."""
    m, mo = cfg.mla, cfg.moe
    found = []
    if m is not None and m.q_lora_rank:
        found.append(f"q_lora_rank {m.q_lora_rank}")
    if m is not None and m.kv_norm:
        found.append("a KV-latent norm")
    if m is not None and m.yarn is not None:
        found.append("YaRN")
    if mo is not None and mo.router != "softmax":
        found.append(f"the {mo.router} router")
    if mo is not None and mo.holds_share:
        found.append(f"a share of {mo.n_experts} of {mo.routed} experts")
    if found:
        raise ValueError(f"{what} on a mesh does not run {', '.join(found)} ({cfg.name})")


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether an (arch, shape) cell is well-defined, with a reason if not."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 524k decode requires sub-quadratic mixing (see DESIGN.md §4)"
    return True, ""


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=max(2, min(4, cfg.n_layers)),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(4, max(1, cfg.n_kv_heads)),
        d_ff=128 if cfg.d_ff > 0 else 0,
        vocab_size=256,
        head_dim=16,
        rope_theta=1e4,
    )
    if cfg.moe is not None:
        kw["moe"] = replace(
            cfg.moe, n_experts=min(8, cfg.moe.n_experts), d_expert=32,
            top_k=min(2, cfg.moe.top_k), n_shared=min(1, cfg.moe.n_shared),
            n_group=min(4, cfg.moe.n_group), topk_group=min(2, cfg.moe.topk_group),
            n_routed=0, held_from=0,
        )
    if cfg.mla is not None:
        kw["mla"] = replace(cfg.mla, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                            v_head_dim=16, q_lora_rank=min(24, cfg.mla.q_lora_rank))
    if cfg.mamba is not None:
        kw["mamba"] = MambaConfig(d_state=8, d_conv=4, expand=2)
    if cfg.xlstm is not None:
        kw["xlstm"] = replace(cfg.xlstm)
    if cfg.encdec is not None:
        kw["encdec"] = replace(cfg.encdec, n_encoder_layers=2, frontend_frames=16)
    if cfg.attn_every:
        kw["attn_every"] = min(cfg.attn_every, 4)
        kw["n_layers"] = 4
    return replace(cfg, name=cfg.name + "-smoke", **kw)
