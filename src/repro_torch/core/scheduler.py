"""Bottleneck-Aware Greedy Makespan Expert Scheduling (paper §4.2) (a copy of
repro/core/scheduler.py: numpy only, the same operations in the same order).

Two phases per MoE layer per decode step:
  1. Greedy initial assignment — "cost" mode (the paper): each expert goes
     to its min-COST device under Eq. 1-4; "makespan" mode (beyond-paper):
     experts in descending-load order go wherever the resulting GLOBAL
     makespan (incl. Eq. 6 contention) is smallest.
  2. Bottleneck-aware refinement: repeatedly take the device with the
     maximum total time (Eq. 5-7), select its highest-cost expert,
     evaluate re-assigning it to the other two domains, apply the move
     minimizing the new global makespan (tie-break: minimum time increase
     on the receiving device), stop when no move improves or `max_iters`.

DIMM contention (Eq. 6): a DIMM serving host weight reads is occupied at
its *internal* bank bandwidth — a striped read of W costs every DIMM
(W/D)/internal_bw of NDP-stealing time; a localized read costs the home
DIMM W/internal_bw. (The host-side wall time, Eq. 2/3 T_DRAM, remains
bounded by channel bandwidth.)

The implementation is vectorized (cost matrix + incremental makespan
updates): a 160-expert layer schedules in well under a millisecond —
"lightweight" as the paper requires.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

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

INF = float("inf")


@dataclass
class ExpertPlacement:
    """Static placement state of one routed expert (set by relayout §4.3)."""

    layout: int  # STRIPED | LOCALIZED
    dimm: int  # home DIMM if LOCALIZED else -1
    gpu_cached: bool = False


@dataclass
class Schedule:
    assign: np.ndarray  # [E] device id (GPU/CPU/NDP)
    gpu_time: float
    cpu_time: float
    dimm_times: np.ndarray  # [D] per-DIMM busy time (NDP + contention)
    makespan: float
    refine_iters: int
    # busy time actually doing compute, for utilization reporting
    gpu_compute: float = 0.0
    cpu_compute: float = 0.0
    ndp_compute: float = 0.0

    @property
    def ndp_time(self) -> float:
        return float(self.dimm_times.max()) if len(self.dimm_times) else 0.0


class _Vectors:
    """Precomputed per-expert arrays for one scheduling problem."""

    __slots__ = (
        "costs", "compute", "uni_cont", "home_cont", "home", "active", "e",
    )

    def __init__(self, sched: "MakespanScheduler", loads, placements, allow_cpu):
        cm, shape = sched.cm, sched.shape
        e = len(loads)
        self.e = e
        loads = np.asarray(loads, np.float64)
        self.active = loads > 0
        layout = np.array([p.layout for p in placements], np.int8)
        cached = np.array([p.gpu_cached for p in placements], bool)
        self.home = np.array(
            [p.dimm if p.dimm >= 0 else 0 for p in placements], np.int64
        )
        w = shape.weight_bytes
        lv = np.maximum(loads, 1e-9)

        f_gpu = np.asarray(cm.f_calc_gpu(shape, lv))
        f_cpu = np.asarray(cm.f_calc_cpu(shape, lv))
        f_ndp = np.asarray(cm.f_calc_ndp(shape, lv))
        t_pcie = cm.t_pcie(w)
        t_dram = np.where(layout == STRIPED, cm.t_dram(w, STRIPED),
                          cm.t_dram(w, LOCALIZED))
        gpu_miss = np.maximum(np.maximum(f_gpu, t_pcie), t_dram)  # Eq. 2
        gpu_cost = np.where(cached, f_gpu, gpu_miss)  # Eq. 1/2
        cpu_cost = np.maximum(f_cpu, t_dram)  # Eq. 3
        ndp_cost = np.where(  # Eq. 4: localized only
            layout == LOCALIZED,
            np.maximum(f_ndp, cm.t_internal(w)),
            INF,
        )
        if not allow_cpu:
            cpu_cost = np.full(e, INF)
        self.costs = np.stack([gpu_cost, cpu_cost, ndp_cost])
        self.costs[:, ~self.active] = 0.0
        self.costs[CPU, ~self.active] = 0.0 if allow_cpu else 0.0
        self.compute = np.stack([f_gpu, f_cpu, f_ndp])
        self.compute[:, ~self.active] = 0.0

        # Eq. 6 contention of a HOST-executed expert (GPU miss or CPU):
        per_dimm_striped = (w / cm.hw.n_dimms) / cm.hw.ndp_internal_bw
        per_dimm_local = w / cm.hw.ndp_internal_bw
        uni = np.where(layout == STRIPED, per_dimm_striped, 0.0)
        hom = np.where(layout == LOCALIZED, per_dimm_local, 0.0)
        # [dev, E]: GPU hits generate none; NDP generates none
        self.uni_cont = np.stack([np.where(cached, 0.0, uni), uni, np.zeros(e)])
        self.home_cont = np.stack([np.where(cached, 0.0, hom), hom, np.zeros(e)])
        self.uni_cont[:, ~self.active] = 0.0
        self.home_cont[:, ~self.active] = 0.0


class MakespanScheduler:
    def __init__(
        self,
        cm: CostModel,
        shape: ExpertShape,
        max_iters: int = 64,
        greedy_mode: str = "cost",
        allow_cpu: bool = True,
    ):
        self.cm = cm
        self.shape = shape
        self.max_iters = max_iters
        self.greedy_mode = greedy_mode
        self.allow_cpu = allow_cpu
        self.n_dimms = cm.hw.n_dimms

    # -------------------------------------------- per-expert API (tests)
    def device_cost(self, dev: int, load: float, pl: ExpertPlacement) -> float:
        if load <= 0:
            return 0.0
        if dev == GPU:
            if pl.gpu_cached:
                return self.cm.t_gpu_hit(self.shape, load)
            return self.cm.t_gpu_miss(self.shape, load, pl.layout)
        if dev == CPU:
            if not self.allow_cpu:
                return INF
            return self.cm.t_cpu(self.shape, load, pl.layout)
        if dev == NDP:
            if pl.layout != LOCALIZED:
                return INF  # Eq. 4 restriction
            return self.cm.t_ndp(self.shape, load)
        raise ValueError(dev)

    def _contention(self, dev: int, pl: ExpertPlacement) -> np.ndarray:
        c = np.zeros(self.n_dimms)
        w = self.shape.weight_bytes
        if dev == GPU and pl.gpu_cached:
            return c  # HBM hit: no host DRAM traffic
        if dev == NDP:
            return c  # weight reads counted in T_NDP itself (internal)
        if pl.layout == STRIPED:
            c[:] = (w / self.n_dimms) / self.cm.hw.ndp_internal_bw
        else:
            c[pl.dimm] += w / self.cm.hw.ndp_internal_bw
        return c

    # ----------------------------------------------------- fast totals
    def _totals_fast(self, assign: np.ndarray, vec: _Vectors, gpu_base: float):
        act = vec.active
        gm = act & (assign == GPU)
        cm_ = act & (assign == CPU)
        nm = act & (assign == NDP)
        gpu_t = gpu_base + vec.costs[GPU][gm].sum()
        cpu_t = vec.costs[CPU][cm_].sum()
        dimm_t = np.bincount(
            vec.home[nm], vec.costs[NDP][nm], minlength=self.n_dimms
        ).astype(np.float64)
        uni = vec.uni_cont[GPU][gm].sum() + vec.uni_cont[CPU][cm_].sum()
        dimm_t += uni
        hm = gm | cm_
        dimm_t += np.bincount(
            vec.home[hm],
            np.where(assign[hm] == GPU, vec.home_cont[GPU][hm], vec.home_cont[CPU][hm]),
            minlength=self.n_dimms,
        )
        return gpu_t, cpu_t, dimm_t

    def _totals(self, assign, loads, placements, gpu_base):
        """Compatibility wrapper returning compute-busy values too."""
        vec = _Vectors(self, loads, placements, self.allow_cpu)
        g, c, d = self._totals_fast(np.asarray(assign), vec, gpu_base)
        act = vec.active
        gc = gpu_base + vec.compute[GPU][act & (assign == GPU)].sum()
        cc = vec.compute[CPU][act & (assign == CPU)].sum()
        nc = vec.compute[NDP][act & (assign == NDP)].sum()
        return g, c, d, gc, cc, nc

    def makespan(self, assign, loads, placements, gpu_base=0.0) -> float:
        g, c, d, *_ = self._totals(assign, loads, placements, gpu_base)
        return max(g, c, float(d.max()) if len(d) else 0.0)  # Eq. 7

    # ------------------------------------------------------- schedule
    def schedule(
        self,
        loads: np.ndarray,
        placements: List[ExpertPlacement],
        gpu_base_time: float = 0.0,
    ) -> Schedule:
        loads = np.asarray(loads, np.float64)
        e = len(loads)
        vec = _Vectors(self, loads, placements, self.allow_cpu)
        act = vec.active

        # --- phase 1: greedy ---
        if self.greedy_mode == "cost":
            assign = np.asarray(np.argmin(vec.costs, axis=0), np.int64)
            assign[~act] = GPU
        else:
            assign = np.full(e, GPU, np.int64)
            gpu_t, cpu_t = gpu_base_time, 0.0
            dimm_t = np.zeros(self.n_dimms)
            for i in np.argsort(-loads):
                if not act[i]:
                    continue
                best_dev, best_key = GPU, None
                for dev in (GPU, CPU, NDP):
                    cost = vec.costs[dev, i]
                    if not np.isfinite(cost):
                        continue
                    g, c = gpu_t, cpu_t
                    d_extra_uni = vec.uni_cont[dev, i]
                    d_home = vec.home_cont[dev, i]
                    dmax = dimm_t.max() + d_extra_uni
                    dh = dimm_t[vec.home[i]] + d_extra_uni + d_home
                    if dev == GPU:
                        g += cost
                    elif dev == CPU:
                        c += cost
                    else:
                        dh += cost
                    key = (max(g, c, dmax, dh), cost)
                    if best_key is None or key < best_key:
                        best_key, best_dev = key, dev
                dev = assign[i] = best_dev
                cost = vec.costs[dev, i]
                if dev == GPU:
                    gpu_t += cost
                elif dev == CPU:
                    cpu_t += cost
                else:
                    dimm_t[vec.home[i]] += cost
                dimm_t += vec.uni_cont[dev, i]
                dimm_t[vec.home[i]] += vec.home_cont[dev, i]

        # --- phase 2: bottleneck-aware refinement ---
        iters = 0
        gpu_t, cpu_t, dimm_t = self._totals_fast(assign, vec, gpu_base_time)
        for iters in range(1, self.max_iters + 1):
            dmax = float(dimm_t.max())
            cur = max(gpu_t, cpu_t, dmax)
            # bottleneck device + its experts' contributions
            if gpu_t >= cpu_t and gpu_t >= dmax:
                bmask = act & (assign == GPU)
                contrib = vec.costs[GPU]
            elif cpu_t >= dmax:
                bmask = act & (assign == CPU)
                contrib = vec.costs[CPU]
            else:
                bd = int(np.argmax(dimm_t))
                # Eq. 6: NDP compute on bd + host reads homed on bd
                on_ndp = act & (assign == NDP) & (vec.home == bd)
                on_host = (
                    act
                    & (assign != NDP)
                    & (vec.home == bd)
                    & (vec.home_cont[GPU] + vec.home_cont[CPU] > 0)
                )
                bmask = on_ndp | on_host
                contrib = np.where(
                    assign == NDP,
                    vec.costs[NDP],
                    np.where(assign == GPU, vec.home_cont[GPU], vec.home_cont[CPU]),
                )
            idxs = np.nonzero(bmask)[0]
            if len(idxs) == 0:
                break
            cand = int(idxs[np.argmax(contrib[idxs])])
            src = int(assign[cand])

            def totals_after(dev):
                g, c = gpu_t, cpu_t
                d = dimm_t.copy()
                # remove cand from src
                if src == GPU:
                    g -= vec.costs[GPU, cand]
                elif src == CPU:
                    c -= vec.costs[CPU, cand]
                else:
                    d[vec.home[cand]] -= vec.costs[NDP, cand]
                d -= vec.uni_cont[src, cand]
                d[vec.home[cand]] -= vec.home_cont[src, cand]
                # add to dev
                if dev == GPU:
                    g += vec.costs[GPU, cand]
                elif dev == CPU:
                    c += vec.costs[CPU, cand]
                else:
                    d[vec.home[cand]] += vec.costs[NDP, cand]
                d += vec.uni_cont[dev, cand]
                d[vec.home[cand]] += vec.home_cont[dev, cand]
                return g, c, d

            best = None  # (makespan, receiver_delta, dev, totals)
            for dev in (GPU, CPU, NDP):
                if dev == src or not np.isfinite(vec.costs[dev, cand]):
                    continue
                g, c, d = totals_after(dev)
                key = (max(g, c, float(d.max())), float(vec.costs[dev, cand]))
                if best is None or key < best[:2]:
                    best = (*key, dev, (g, c, d))
            if best is None or best[0] >= cur - 1e-12:
                break
            assign[cand] = best[2]
            gpu_t, cpu_t, dimm_t = best[3]

        gc = gpu_base_time + vec.compute[GPU][act & (assign == GPU)].sum()
        cc = vec.compute[CPU][act & (assign == CPU)].sum()
        nc = vec.compute[NDP][act & (assign == NDP)].sum()
        return Schedule(
            assign=assign,
            gpu_time=gpu_t,
            cpu_time=cpu_t,
            dimm_times=dimm_t,
            makespan=max(gpu_t, cpu_t, float(dimm_t.max())),
            refine_iters=iters,
            gpu_compute=gc,
            cpu_compute=cc,
            ndp_compute=nc,
        )
