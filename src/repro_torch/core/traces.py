"""Synthetic expert-activation traces matching the paper's Fig. 3 (a copy
of repro/core/traces.py, numpy and json only; the `.npz` + json format
is the same, so either package loads the other's files).

The paper extracts activation traces from LMSys / CodeAlpaca on real
models; offline we synthesize statistically-matching traces: a Zipf
popularity base per layer, log-space AR(1) temporal drift (giving the
EMA predictor its ~78% accuracy operating point), and per-step
multinomial sampling of the token->expert assignments under the top-k
constraint.

Target marginals (Fig. 3b): ~70% of experts are cold and process ~8% of
tokens; 20-40% are warm carrying up to ~70%; the few hot experts take
the rest. `calibrate_zipf` solves for the exponent that reproduces the
cold-token share for a given expert count.

On-disk replayable traces: `RoutingTrace` wraps a generated loads array
(`[T, L, E]` expert-token counts) and `RequestTrace` a full serving
workload (arrival steps + prompts + decode lengths with skewed,
phase-shifting token populations that induce skewed expert routing
through the live router). Both round-trip through a single-file `.npz`
with a JSON meta blob, so CI replays the identical workload on every
machine (`serving/replay.py` drives a `RequestTrace` through
`ServingLoop`).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class TraceSpec:
    n_steps: int
    n_layers: int
    n_experts: int
    top_k: int
    tokens_per_step: int  # aggregated batch size (zigzag/offline batching)
    # Fig. 3b marginals
    hot_expert_frac: float = 0.02
    hot_token_share: float = 0.25
    warm_expert_frac: float = 0.30
    cold_token_share: float = 0.08
    drift_rho: float = 0.92  # AR(1) persistence (temporal locality)
    drift_sigma: float = 0.35
    # non-stationary regime drift: the popularity base itself random-walks
    # (real traces shift with conversation topics), so offline placements
    # go stale and relayout/rebalancing has real work to do (paper §4.3)
    base_walk_sigma: float = 0.08
    swap_prob: float = 0.03  # chance per step of a rank swap event
    # mid-stream phase shifts: at each listed step the popularity base is
    # re-permuted (a topic change re-ranks WHO is hot while the Fig. 3
    # marginals stay fixed); the drift state chases the new base at the
    # AR(1) rate, so offline/static placements go stale abruptly.
    phase_steps: Tuple[int, ...] = ()
    seed: int = 0


def fig3_base_distribution(spec: TraceSpec) -> np.ndarray:
    """Construct the rank-popularity base directly from the paper's
    measured marginals (Fig. 3b): hot/warm/cold expert fractions and
    token shares, geometric decay within each band."""
    e = spec.n_experts
    n_hot = max(1, int(round(spec.hot_expert_frac * e)))
    n_warm = max(1, int(round(spec.warm_expert_frac * e)))
    n_cold = e - n_hot - n_warm
    warm_share = 1.0 - spec.hot_token_share - spec.cold_token_share

    def band(n, total, decay):
        w = decay ** np.arange(n)
        return total * w / w.sum()

    base = np.concatenate(
        [
            band(n_hot, spec.hot_token_share, 0.7),
            band(n_warm, warm_share, 0.93),
            band(n_cold, spec.cold_token_share, 0.97),
        ]
    )
    return base / base.sum()


def generate_trace(spec: TraceSpec) -> np.ndarray:
    """Returns loads [n_steps, n_layers, n_experts] int64 token counts.

    Per step each of `tokens_per_step` tokens picks `top_k` distinct
    experts; loads sum to tokens_per_step * top_k per (step, layer).
    """
    rng = np.random.default_rng(spec.seed)
    e = spec.n_experts
    base = fig3_base_distribution(spec)

    loads = np.zeros((spec.n_steps, spec.n_layers, e), dtype=np.int64)
    for layer in range(spec.n_layers):
        # each layer gets its own popularity permutation (experts are
        # specialized per layer) and its own drift path
        perm = rng.permutation(e)
        logp = np.log(base[perm])
        mean_logp = logp.copy()
        state = logp.copy()
        base_mu, base_sd = mean_logp.mean(), mean_logp.std()
        phase_set = set(spec.phase_steps)
        for t in range(spec.n_steps):
            if t in phase_set:
                mean_logp = mean_logp[rng.permutation(e)]
            # regime drift: base popularity random-walks + occasional swaps.
            # Variance-preserving: re-standardized so regime changes shuffle
            # WHO is popular without reshaping the marginal distribution
            # (the paper's Fig. 3 marginals are stationary across batches).
            mean_logp = mean_logp + spec.base_walk_sigma * rng.standard_normal(e)
            mean_logp = (
                (mean_logp - mean_logp.mean())
                / max(mean_logp.std(), 1e-9) * base_sd + base_mu
            )
            if rng.random() < spec.swap_prob:
                i, j = rng.integers(0, e, 2)
                mean_logp[i], mean_logp[j] = mean_logp[j], mean_logp[i]
            state = (
                spec.drift_rho * state
                + (1 - spec.drift_rho) * mean_logp
                + spec.drift_sigma * rng.standard_normal(e)
            )
            p = np.exp(state - state.max())
            p /= p.sum()
            # top-k without replacement per token ~ approximated by
            # multinomial of T*k draws with a per-expert cap of T
            counts = rng.multinomial(spec.tokens_per_step * spec.top_k, p)
            over = counts - spec.tokens_per_step
            excess = int(np.clip(over, 0, None).sum())
            if excess:
                counts = np.minimum(counts, spec.tokens_per_step)
                room = spec.tokens_per_step - counts
                redist = rng.multinomial(excess, room / room.sum())
                counts = counts + redist
            loads[t, layer] = counts
    return loads


def trace_for_model(cfg, batch_size: int, n_steps: int = 64, seed: int = 0) -> np.ndarray:
    """Trace shaped for a ModelConfig's MoE layers."""
    n_moe_layers = sum(cfg.uses_moe_layer(i) for i in range(cfg.n_layers))
    return generate_trace(
        TraceSpec(
            n_steps=n_steps,
            n_layers=n_moe_layers,
            n_experts=cfg.moe.n_experts,
            top_k=cfg.moe.top_k,
            tokens_per_step=batch_size,
            seed=seed,
        )
    )


# ---------------------------------------------------------------------------
# Replayable on-disk traces (.npz single file, JSON meta blob)
# ---------------------------------------------------------------------------

TRACE_FORMAT_VERSION = 1
# canonical scratch suffix — ci_check's tracked-artifact gate and
# .gitignore both key on it, so bench scratch traces never get committed
TRACE_SUFFIX = ".trace.npz"


def _check_header(data, kind: str, path) -> None:
    got_kind = str(data["kind"])
    if got_kind != kind:
        raise ValueError(f"{path}: expected a {kind!r} trace, got {got_kind!r}")
    version = int(data["version"])
    if version > TRACE_FORMAT_VERSION:
        raise ValueError(
            f"{path}: trace format v{version} is newer than supported "
            f"v{TRACE_FORMAT_VERSION}"
        )


@dataclass(eq=False)
class RoutingTrace:
    """A saved `[n_steps, n_layers, n_experts]` expert-load trace.

    The offline artifact for simulator/scheduler studies: generate once
    (optionally with `TraceSpec.phase_steps` mid-stream shifts), commit
    or cache the file, and every replay sees the identical load
    sequence."""

    loads: np.ndarray
    meta: Dict = field(default_factory=dict)

    @classmethod
    def from_spec(cls, spec: TraceSpec) -> "RoutingTrace":
        meta = {k: (list(v) if isinstance(v, tuple) else v)
                for k, v in vars(spec).items()}
        return cls(loads=generate_trace(spec), meta={"spec": meta})

    def save(self, path) -> None:
        np.savez_compressed(
            path,
            kind="routing",
            version=TRACE_FORMAT_VERSION,
            loads=self.loads,
            meta=json.dumps(self.meta, sort_keys=True),
        )

    @classmethod
    def load(cls, path) -> "RoutingTrace":
        with np.load(path, allow_pickle=False) as data:
            _check_header(data, "routing", path)
            return cls(
                loads=np.asarray(data["loads"]),
                meta=json.loads(str(data["meta"])),
            )


@dataclass(eq=False)
class RequestTrace:
    """A saved serving workload: per-request arrival step, prompt token
    ids, and decode length.

    `arrival_step[i]` is the loop iteration at which request i becomes
    visible to admission — `serving/replay.py` submits it then, so
    bursts and lulls replay exactly. Prompt token populations carry the
    skew (see `synth_request_trace`): a Zipf-over-vocab distribution
    whose permutation is reshuffled at each phase boundary, which
    induces shifting expert popularity through the model's router."""

    arrival_step: np.ndarray  # [R] int64
    prompt_lens: np.ndarray  # [R] int64
    prompt_tokens: np.ndarray  # [sum(prompt_lens)] int64, concatenated
    new_tokens: np.ndarray  # [R] int64
    meta: Dict = field(default_factory=dict)

    def __post_init__(self):
        self.arrival_step = np.asarray(self.arrival_step, dtype=np.int64)
        self.prompt_lens = np.asarray(self.prompt_lens, dtype=np.int64)
        self.prompt_tokens = np.asarray(self.prompt_tokens, dtype=np.int64)
        self.new_tokens = np.asarray(self.new_tokens, dtype=np.int64)
        if int(self.prompt_lens.sum()) != self.prompt_tokens.size:
            raise ValueError(
                f"prompt_lens sum to {int(self.prompt_lens.sum())} but "
                f"prompt_tokens has {self.prompt_tokens.size} ids"
            )
        if not (self.arrival_step.size == self.prompt_lens.size
                == self.new_tokens.size):
            raise ValueError("per-request arrays must share length")

    def __len__(self) -> int:
        return int(self.arrival_step.size)

    def prompt(self, i: int) -> np.ndarray:
        off = int(self.prompt_lens[:i].sum())
        return self.prompt_tokens[off:off + int(self.prompt_lens[i])]

    def save(self, path) -> None:
        np.savez_compressed(
            path,
            kind="requests",
            version=TRACE_FORMAT_VERSION,
            arrival_step=self.arrival_step,
            prompt_lens=self.prompt_lens,
            prompt_tokens=self.prompt_tokens,
            new_tokens=self.new_tokens,
            meta=json.dumps(self.meta, sort_keys=True),
        )

    @classmethod
    def load(cls, path) -> "RequestTrace":
        with np.load(path, allow_pickle=False) as data:
            _check_header(data, "requests", path)
            return cls(
                arrival_step=np.asarray(data["arrival_step"]),
                prompt_lens=np.asarray(data["prompt_lens"]),
                prompt_tokens=np.asarray(data["prompt_tokens"]),
                new_tokens=np.asarray(data["new_tokens"]),
                meta=json.loads(str(data["meta"])),
            )


def load_trace(path):
    """Open either trace kind by header dispatch."""
    with np.load(path, allow_pickle=False) as data:
        kind = str(data["kind"])
    if kind == "routing":
        return RoutingTrace.load(path)
    if kind == "requests":
        return RequestTrace.load(path)
    raise ValueError(f"{path}: unknown trace kind {kind!r}")


def synth_request_trace(
    n_requests: int,
    vocab_size: int,
    *,
    prompt_len: int = 8,
    prompt_len_jitter: int = 0,
    new_tokens: int = 6,
    zipf_a: float = 1.2,
    n_phases: int = 2,
    burst: int = 2,
    gap_steps: int = 2,
    seed: int = 0,
) -> RequestTrace:
    """Synthesize a skew-churn serving workload.

    Token ids are drawn Zipf(`zipf_a`) over a permuted vocab — a small
    population of ids dominates, so a handful of experts absorb most of
    the routing (the Fig. 3 skew, induced through the live router
    rather than injected as counts). The permutation is reshuffled at
    each of `n_phases` contiguous request phases: WHICH ids (hence
    which experts) are popular flips mid-stream, exactly the regime
    where static tiers go stale. Arrivals come in bursts of `burst`
    requests every `gap_steps` loop iterations (load imbalance in
    time)."""
    if n_requests < 1 or vocab_size < 2 or n_phases < 1:
        raise ValueError("need n_requests >= 1, vocab_size >= 2, n_phases >= 1")
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    zipf = ranks ** (-zipf_a)
    zipf /= zipf.sum()

    phase_of = (np.arange(n_requests) * n_phases) // n_requests
    perms = [rng.permutation(vocab_size) for _ in range(n_phases)]

    lens = np.full(n_requests, prompt_len, dtype=np.int64)
    if prompt_len_jitter:
        lens += rng.integers(
            -prompt_len_jitter, prompt_len_jitter + 1, size=n_requests
        )
        lens = np.maximum(lens, 1)
    toks = [
        perms[phase_of[i]][rng.choice(vocab_size, size=int(lens[i]), p=zipf)]
        for i in range(n_requests)
    ]
    arrival = (np.arange(n_requests) // burst) * gap_steps
    return RequestTrace(
        arrival_step=arrival,
        prompt_lens=lens,
        prompt_tokens=np.concatenate(toks),
        new_tokens=np.full(n_requests, new_tokens, dtype=np.int64),
        meta={
            "generator": "synth_request_trace",
            "vocab_size": vocab_size,
            "zipf_a": zipf_a,
            "n_phases": n_phases,
            "phase_starts": [
                int(np.argmax(phase_of == p)) for p in range(n_phases)
            ],
            "burst": burst,
            "gap_steps": gap_steps,
            "seed": seed,
        },
    )
