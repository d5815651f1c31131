"""TriMoE system simulator (paper §5 evaluation methodology) (a copy of
repro/core/simulator.py: numpy only, the same operations in the same order).

The paper evaluates its novel hardware with a cycle-accurate DRAM
simulator + RTL-synthesized NDP units; here the same tri-domain system is
simulated at the expert-event level using the Eq. 1-7 cost model, the
§4.2 scheduler, and the §4.3 predictor/relayout engine, driven by
Fig. 3-calibrated activation traces.

One simulator, five policies:
  trimoe   — GPU + AMX-CPU + DIMM-NDP, full scheduler (the paper)
  gpu_ndp  — ablation base: CPU disabled (binary GPU/NDP partitioning)
  klotski  — GPU-only, hot-expert prefetch, PCIe-overlapped cold loads
  enkt     — Enhanced KTransformers: hot on GPU, all other routed
             experts on the AMX CPU (host-bandwidth bound)
  monde    — GPU-NDP with cost-modeled weight-vs-activation migration

Decode step timeline per MoE layer: the GPU runs attention/MLP (+shared
experts) — this is the migration overlap window — then the routed-expert
phase runs at the scheduled makespan. Migrations that cannot hide in the
window surface as visible overhead (paper: <3.3%).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.cost_model import (
    CPU,
    GPU,
    LOCALIZED,
    NDP,
    STRIPED,
    CostModel,
    ExpertShape,
)
from repro_torch.core.predictor import EMALoadPredictor
from repro_torch.core.relayout import RelayoutEngine
from repro_torch.core.scheduler import ExpertPlacement, MakespanScheduler, Schedule
from repro_torch.core.tiers import COLD, HOT, WARM, TierThresholds
from repro_torch.hardware import TRIMOE_HW, TriMoEHardware


# ------------------------------------------------------------- sim model
@dataclass(frozen=True)
class SimModel:
    name: str
    d_model: int
    d_expert: int
    n_experts: int
    top_k: int
    n_shared: int
    n_moe_layers: int
    attn_mlp_flops_per_token: float  # non-MoE decode FLOPs / token / layer

    @classmethod
    def from_config(cls, cfg, context_len: int = 1024):
        mo = cfg.moe
        n_moe = sum(cfg.uses_moe_layer(i) for i in range(cfg.n_layers))
        d, hd = cfg.d_model, cfg.resolved_head_dim
        if cfg.mla is not None:
            m = cfg.mla
            proj = d * cfg.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            proj += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            proj += m.kv_lora_rank * cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            proj += cfg.n_heads * m.v_head_dim * d
            score = 2 * cfg.n_heads * context_len * (m.kv_lora_rank + m.qk_rope_head_dim)
        else:
            proj = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d
            score = 2 * cfg.n_heads * context_len * hd
        flops = 2 * proj + 2 * score
        return cls(
            name=cfg.name,
            d_model=d,
            d_expert=mo.d_expert,
            n_experts=mo.n_experts,
            top_k=mo.top_k,
            n_shared=mo.n_shared,
            n_moe_layers=n_moe,
            attn_mlp_flops_per_token=float(flops),
        )


@dataclass
class SimFlags:
    policy: str = "trimoe"
    enable_refinement: bool = True
    enable_relayout: bool = True
    hbm_expert_bytes: float = 12e9  # HBM budget for cached routed experts
    cpu_flops_scale: float = 1.0  # §5.4.2 sensitivity
    n_dimms: Optional[int] = None  # §5.4.1 sensitivity
    context_len: int = 1024
    greedy_mode: str = "cost"  # "cost" (paper §4.2) | "makespan" (ours)
    # The offline initial layout is derived from *historical* traces; the
    # live workload then drifts away from it. warmup_steps controls how
    # stale the offline analysis is when measurement starts.
    warmup_steps: int = 16


@dataclass
class SimResult:
    policy: str
    batch_size: int
    n_steps: int
    moe_time: float  # total routed-expert time
    window_time: float  # total attention/MLP (+shared) GPU time
    step_time: float  # e2e decode time
    migration_overhead: float  # visible (unhidden) migration seconds
    utils: Dict[str, float]
    predictor_accuracy: float = 0.0
    migration_accuracy: float = 0.0
    migrations_executed: int = 0
    predictor_bytes: int = 0

    @property
    def throughput(self) -> float:
        return self.batch_size * self.n_steps / self.step_time

    @property
    def moe_latency_per_layer_ms(self) -> float:
        return 1e3 * self.moe_time / self.n_steps


class TriMoESimulator:
    def __init__(
        self,
        model: SimModel,
        trace: np.ndarray,  # [steps, n_moe_layers, E]
        flags: SimFlags = SimFlags(),
        hw: TriMoEHardware = TRIMOE_HW,
        thresholds: TierThresholds = TierThresholds(),
        seed: int = 0,
    ):
        if flags.n_dimms is not None:
            hw = dataclasses.replace(hw, n_dimms=flags.n_dimms)
        if flags.cpu_flops_scale != 1.0:
            hw = dataclasses.replace(hw, cpu_flops=hw.cpu_flops * flags.cpu_flops_scale)
        self.hw = hw
        self.model = model
        self.trace = trace
        self.flags = flags
        self.th = thresholds
        self.shape = ExpertShape(model.d_model, model.d_expert)
        self.cm = CostModel(hw=hw)
        self.sched = MakespanScheduler(
            self.cm, self.shape, greedy_mode=flags.greedy_mode
        )
        self.rng = np.random.default_rng(seed)

        nl, ne = model.n_moe_layers, model.n_experts
        w = self.shape.weight_bytes
        # HBM budget caps the resident hot set; the offloading regime the
        # paper targets keeps >90% of routed experts off-GPU, so the hot
        # set never exceeds E/8 even for small models that would fit.
        self.hot_slots_per_layer = min(
            max(1, int(flags.hbm_expert_bytes / w / max(nl, 1))),
            max(1, ne // 8),
        )
        self.predictor = EMALoadPredictor(nl, ne, thresholds=thresholds)
        self.relayout = RelayoutEngine(
            self.cm, self.shape, hbm_expert_slots=self.hot_slots_per_layer,
            thresholds=thresholds,
        )
        self.placements = self._init_placements()

    # ------------------------------------------------- offline layout
    def _init_placements(self) -> List[List[ExpertPlacement]]:
        """Offline trace analysis (paper §4.3): rank by first-step load;
        top -> GPU-cached+striped, warm band -> striped, tail -> localized
        round-robin across DIMMs. Binary policies localize all non-hot."""
        from repro_torch.core.tiers import classify

        out = []
        e = self.model.n_experts
        binary = self.flags.policy in ("gpu_ndp", "monde")
        for layer in range(self.model.n_moe_layers):
            loads0 = self.trace[0, layer]
            order = np.argsort(-loads0)
            tiers0 = classify(loads0, self.th)
            pls = [ExpertPlacement(STRIPED, -1) for _ in range(e)]
            rr = 0  # round-robin DIMM assignment for localized experts
            for rank, idx in enumerate(order):
                cached = rank < self.hot_slots_per_layer
                if binary:
                    # binary GPU/NDP systems localize everything off-GPU
                    pls[idx] = ExpertPlacement(
                        LOCALIZED, rr % self.hw.n_dimms, gpu_cached=cached
                    )
                    rr += 1
                elif tiers0[idx] == COLD and not cached:
                    pls[idx] = ExpertPlacement(LOCALIZED, rr % self.hw.n_dimms)
                    rr += 1
                else:
                    pls[idx] = ExpertPlacement(STRIPED, -1, gpu_cached=cached)
            out.append(pls)
        return out

    # ------------------------------------------------------ per-layer
    def _window(self, batch: int) -> float:
        """GPU attention/MLP + shared expert time = overlap window."""
        flops = self.model.attn_mlp_flops_per_token * batch
        t = flops / (self.hw.gpu_flops * 0.5)  # decode GEMV-ish efficiency
        if self.model.n_shared:
            t += self.model.n_shared * self.cm.t_gpu_hit(self.shape, batch)
        return t

    def _layer_klotski(self, loads: np.ndarray, pls) -> Schedule:
        """GPU-only: compute everything on GPU; PCIe loads overlap compute."""
        active = np.nonzero(loads > 0)[0]
        compute = sum(self.cm.t_gpu_hit(self.shape, loads[i]) for i in active)
        gpu_flops = float(sum(self.shape.flops(loads[i]) for i in active))
        pcie_bytes = sum(
            self.shape.weight_bytes for i in active if not pls[i].gpu_cached
        )
        pcie = pcie_bytes / self.hw.pcie_bw
        makespan = max(compute, pcie)
        return Schedule(
            assign=np.full(len(loads), GPU),
            gpu_time=makespan, cpu_time=0.0,
            dimm_times=np.zeros(self.hw.n_dimms),
            makespan=makespan, refine_iters=0,
            gpu_compute=gpu_flops / self.hw.gpu_flops,
        )

    def _layer_enkt(self, loads: np.ndarray, pls) -> Schedule:
        """Hot on GPU (cached), every other routed expert on the AMX CPU."""
        active = np.nonzero(loads > 0)[0]
        gpu_t = cpu_t = cpu_flops_used = gpu_flops_used = 0.0
        cpu_bytes = 0.0
        for i in active:
            if pls[i].gpu_cached:
                gpu_t += self.cm.t_gpu_hit(self.shape, loads[i])
                gpu_flops_used += float(self.shape.flops(loads[i]))
            else:
                # same per-expert Eq. 3 form as TriMoE's CPU path (striped)
                cpu_t += self.cm.t_cpu(self.shape, loads[i], STRIPED)
                cpu_bytes += self.shape.weight_bytes
                cpu_flops_used += float(self.shape.flops(loads[i]))
        cpu_wall = cpu_t
        makespan = max(gpu_t, cpu_wall)
        return Schedule(
            assign=np.where([pls[i].gpu_cached for i in range(len(loads))], GPU, CPU),
            gpu_time=gpu_t, cpu_time=cpu_wall,
            dimm_times=np.zeros(self.hw.n_dimms),
            makespan=makespan, refine_iters=0,
            gpu_compute=gpu_flops_used / self.hw.gpu_flops,
            cpu_compute=cpu_flops_used / self.hw.cpu_flops,
        )

    # ------------------------------------------------------------ run
    def run(self, n_steps: Optional[int] = None) -> SimResult:
        model, flags = self.model, self.flags
        total = n_steps or self.trace.shape[0]
        warmup = min(flags.warmup_steps, max(0, self.trace.shape[0] - 1))
        total = min(total + warmup, self.trace.shape[0])
        steps = total - warmup
        batch = int(self.trace[0, 0].sum() / model.top_k)
        window = self._window(batch)
        allow_cpu = flags.policy in ("trimoe", "enkt")
        use_sched = flags.policy in ("trimoe", "gpu_ndp", "monde")
        self.sched.max_iters = 64 if (
            flags.enable_refinement or flags.policy in ("monde",)
        ) else 0

        moe_time = window_time = overhead = 0.0
        busy = {"gpu": 0.0, "cpu": 0.0, "ndp": 0.0}
        useful = {"gpu": 0.0, "cpu": 0.0, "ndp": 0.0}
        migrations = 0

        for t in range(total):
            measured = t >= warmup
            for li in range(model.n_moe_layers):
                loads = self.trace[t, li].astype(np.float64)
                pls = self.placements[li]
                if flags.policy == "klotski":
                    sc = self._layer_klotski(loads, pls)
                elif flags.policy == "enkt":
                    sc = self._layer_enkt(loads, pls)
                else:
                    if not allow_cpu:
                        # disable the CPU path by making it unattractive
                        sc = self._schedule_no_cpu(loads, pls)
                    else:
                        sc = self.sched.schedule(loads, pls)
                if measured:
                    moe_time += sc.makespan
                    window_time += window
                    busy["gpu"] += sc.gpu_time
                    busy["cpu"] += sc.cpu_time
                    busy["ndp"] += float(sc.dimm_times.max())
                    useful["gpu"] += sc.gpu_compute
                    useful["cpu"] += sc.cpu_compute
                    useful["ndp"] += sc.ndp_compute

                # ---- background migration for the NEXT layer (paper §4.3)
                self.predictor.update(li, loads)
                nxt = (li + 1) % model.n_moe_layers
                if flags.policy in ("monde", "gpu_ndp"):
                    # weight-migration-to-GPU only (MoNDE's trade-off)
                    self._prefetch_only(nxt)
                elif flags.policy == "trimoe" and flags.enable_relayout:
                    tasks = self.relayout.plan(
                        self.predictor.predict(nxt), self.placements[nxt]
                    )
                    rep = self.relayout.execute(tasks, self.placements[nxt], window)
                    if measured:
                        overhead += rep.overflow
                        migrations += len(rep.executed)

        step_time = moe_time + window_time + overhead
        # useful[*] is peak-seconds on ONE unit; NDP busy is the max DIMM,
        # so normalize by the DIMM count to get fleet utilization.
        utils = {
            "gpu": useful["gpu"] / busy["gpu"] if busy["gpu"] > 0 else 0.0,
            "cpu": useful["cpu"] / busy["cpu"] if busy["cpu"] > 0 else 0.0,
            "ndp": (
                useful["ndp"] / (self.hw.n_dimms * busy["ndp"])
                if busy["ndp"] > 0
                else 0.0
            ),
        }
        return SimResult(
            policy=flags.policy,
            batch_size=batch,
            n_steps=steps,
            moe_time=moe_time,
            window_time=window_time,
            step_time=step_time,
            migration_overhead=overhead,
            utils=utils,
            predictor_accuracy=self.predictor.stats.accuracy,
            migration_accuracy=self.predictor.stats.migration_accuracy,
            migrations_executed=migrations,
            predictor_bytes=self.predictor.metadata_bytes,
        )

    # --------------------------------------------------------- helpers
    def _schedule_no_cpu(self, loads, pls) -> Schedule:
        """Binary GPU-NDP scheduling: the CPU path disabled (Eq. 3 absent)."""
        prev = self.sched.allow_cpu
        self.sched.allow_cpu = False
        try:
            return self.sched.schedule(loads, pls)
        finally:
            self.sched.allow_cpu = prev

    def _prefetch_only(self, layer: int) -> None:
        """MoNDE-style: promote the predicted-hottest experts into HBM."""
        pred = self.predictor.predict(layer)
        pls = self.placements[layer]
        order = np.argsort(-pred)
        cached = {i for i, p in enumerate(pls) if p.gpu_cached}
        want = set(order[: self.hot_slots_per_layer].tolist())
        for i in cached - want:
            pls[i].gpu_cached = False
        for i in want - cached:
            pls[i].gpu_cached = True


def simulate(
    cfg,
    batch_size: int,
    policy: str = "trimoe",
    n_steps: int = 32,
    seed: int = 0,
    flags: Optional[SimFlags] = None,
    trace: Optional[np.ndarray] = None,
    **flag_kw,
) -> SimResult:
    """Convenience entry: ModelConfig + batch -> SimResult."""
    from repro_torch.core.traces import trace_for_model

    model = SimModel.from_config(cfg)
    f = flags or SimFlags(policy=policy, **flag_kw)
    if flags is None:
        f.policy = policy
    if trace is None:
        trace = trace_for_model(
            cfg, batch_size, n_steps=n_steps + f.warmup_steps, seed=seed
        )
    return TriMoESimulator(model, trace, f).run(n_steps)
