"""One run of one cell: set-up, warm-up and ramp, the measured window, the
traced slice of a `--trace 1` run, and the comparison that decides
`correct`. Everything a cell, a configuration, a traffic mix or a metric
owns is read from its own file, found by name:

    BENCHMARK.json                 cells, configurations, metrics and units
    bench/workloads/<cell>.json    loop arguments, load, ramp, limits
    bench/configs/<config>.json    the model (the file BENCHMARK.json names)
    bench/traffic/<traffic>.json   the mix, read by its generator
    bench/traffic/<generator>.py   the mix's generator (mix.py)
    bench/arrivals/<process>.py    an open loop's arrival process (mix.py)
    bench/families/<model_type>.py the configuration's model family (spec.py)
    bench/ports/<model_type>.py    the port's configuration of it (system.py)
    bench/metrics/<metric>.py      read(record) -> number or None

The timed path is `ServingLoop.submit` / `ServingLoop.step_once`. Tokens
are stamped by the host clock after each step (each step ends with the
sampled tokens copied to the host). A closed loop's request is due when
its client sends it, right after the client's previous request
completes; an open loop's when its schedule says, so a stall counts
against the requests behind it.
"""
from __future__ import annotations

import gc
import json
import math
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from mix import Generator, gaps_of, traffic_of
from record import MoECall, Record
from spec import dims_of, load_json, module_at

CORRECT_SAMPLE_TOKENS = 384  # served tokens the reference checks, at least
SLICE_S = 3.0  # the traced slice's length at least, seconds


# ---------------------------------------------------------------- files
def load_cell(bench_dir: Path, cell: str) -> dict:
    """A cell's entry of BENCHMARK.json with its workload file, its
    configuration's and its traffic mix's contents."""
    bench = load_json(bench_dir.parent / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return {
        **entry,
        "workload": load_json(bench_dir / "workloads" / f"{cell}.json"),
        "model": load_json(bench_dir.parent / conf["file"]),
        "mix": load_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        "benchmark": bench,
    }


def metrics_for(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of `cell` reports: its end-to-end ones, or with
    `trace` its per-layer ones."""
    out = []
    for m in bench["per_layer" if trace else "end_to_end"]:
        if cell in m.get("workloads", [cell]):
            out.append(m)
    return out


def reader(bench_dir: Path, name: str) -> Callable[[Record], Optional[float]]:
    return module_at(bench_dir / "metrics" / f"{name}.py").read


# ---------------------------------------------------------------- driving
class _Track:
    __slots__ = ("req", "due", "seen", "t_last", "client")

    def __init__(self, req, due: float, client: Optional[int]):
        self.req, self.due, self.seen, self.t_last, self.client = req, due, 0, None, client


class LoadGen:
    """Submits the cell's traffic to the loop and stamps every token."""

    def __init__(self, loop, traffic: Generator, load: dict, gaps=None,
                 clock=time.perf_counter):
        from repro_torch.serving.batching import Request

        self.loop, self.traffic, self.clock, self.Request = loop, traffic, clock, Request
        self.clients = load.get("clients")
        self.rate = load.get("rate_per_s")
        self.next_k = 0
        self.inflight: Dict[int, _Track] = {}
        self.t0 = math.inf  # the window's start
        self.tokens, self.sent = 0, 0
        self.ttft: List[float] = []
        self.itl: List[float] = []
        self.finished: List[tuple] = []  # (prompt, generated) completed in the window
        self.queue: List[tuple] = []  # (time, waiting requests)
        self._gaps = gaps
        self._next_due = None

    def _submit(self, due: float, client=None, share: float = 1.0) -> None:
        prompt, n_new = self.traffic.request(self.next_k)
        n_new = max(1, round(n_new * share))
        req = self.Request(rid=self.next_k, prompt=prompt, max_new_tokens=n_new)
        self.next_k += 1
        self.loop.submit(req)
        self.inflight[req.rid] = _Track(req, due, client)
        if due >= self.t0:
            self.sent += 1

    def start(self, seed: int) -> None:
        """The first requests: every client's, or the schedule's head. A
        closed loop's clients start as conversations already under way:
        client c's first request stops after a share (order drawn from the
        seed, evenly spread over (0, 1]) of its output, so completions are
        spread over a request's lifetime from the start instead of coming
        in one wave."""
        now = self.clock()
        if self.clients:
            share = (np.random.default_rng([int(seed), 12]).permutation(self.clients) + 0.5)
            for c in range(self.clients):
                self._submit(now, c, share=float(share[c]) / self.clients)
        else:
            self._next_due = now

    def submit_due(self) -> None:
        if self._gaps is None:
            return
        now = self.clock()
        while self._next_due <= now:
            self._submit(self._next_due)
            self._next_due += next(self._gaps)

    def idle_wait(self) -> None:
        """Nothing to serve: wait for the schedule's next arrival."""
        if not self.inflight and self._next_due is not None:
            time.sleep(max(0.0, self._next_due - self.clock()))

    def observe(self, now: float) -> None:
        in_window = now >= self.t0
        done = []
        for rid, t in self.inflight.items():
            n = len(t.req.generated)
            if n == t.seen:
                continue
            new = n - t.seen
            if in_window:
                self.tokens += new
                if t.seen == 0:
                    self.ttft.append(now - t.due)
                elif t.t_last >= self.t0:
                    self.itl.append(now - t.t_last)
                self.itl.extend([0.0] * (new - 1))  # delivered together
            t.seen, t.t_last = n, now
            if t.req.done:
                done.append(rid)
        for rid in done:
            t = self.inflight.pop(rid)
            if in_window:
                self.finished.append((np.asarray(t.req.prompt), list(t.req.generated)))
            if t.client is not None:
                self._submit(now, t.client)

    def step(self) -> float:
        self.submit_due()
        self.idle_wait()
        t_a = self.clock()
        self.loop.step_once()
        t_b = self.clock()
        self.observe(t_b)
        self.queue.append((t_b, len(self.loop.batcher.queue) + len(self.loop._prefill_tasks)))
        return t_b - t_a

    def first_tokens_pending(self, rids) -> bool:
        return any(rid in self.inflight and self.inflight[rid].seen == 0 for rid in rids)


def _queue_slope(queue: List[tuple], t0: float) -> float:
    """Least-squares growth of the waiting requests over the window, per
    second (the knee sweep's test of a sustained rate)."""
    pts = np.asarray([q for q in queue if q[0] >= t0], np.float64)
    if len(pts) < 2:
        return 0.0
    return float(np.polyfit(pts[:, 0] - t0, pts[:, 1], 1)[0])


# ---------------------------------------------------------------- tracing
SPANS = {"step_once": "step", "_admit": "admit", "_prefill_step": "prefill_chunk"}
ENGINE_SPANS = {"step_slots_paged": "decode", "prefill_slots_paged": "prefill",
                "plan_migrations": "replan", "apply_planned": "migrate"}


class Tracing:
    """A traced run's instruments: the benchmark's host ranges around its
    calls into the loop and the engine, a record of each MoE layer call's
    counts and of each decode / prefill call's rows, and torch.profiler
    over one slice of the window."""

    def __init__(self, loop, torch, cuda: bool):
        self.torch, self.loop, self.cuda = torch, loop, cuda
        self.profiled = False
        self.kinds: set = set()  # decode / prefill MoE calls seen in the slice
        self.moe: List[tuple] = []
        self.decode_rows: List[tuple] = []  # (live rows, ctx lengths, profiled)
        self.prefill: List[tuple] = []  # (pasts, lengths, profiled)
        self._undo: List[Callable] = []
        rf = torch.profiler.record_function
        for attr, span in SPANS.items():
            self._wrap(loop, attr, span, rf)
        for attr, span in ENGINE_SPANS.items():
            self._wrap(loop.engine, attr, span, rf)
        import repro_torch.serving.tiered_moe as tm

        orig = tm.tiered_moe_forward

        def moe_forward(p, state, cfg, x, *a, **kw):
            y, counts = orig(p, state, cfg, x, *a, **kw)
            self.moe.append((x.shape[1] == 1, counts, self.profiled))
            if self.profiled:
                self.kinds.add(x.shape[1] == 1)
            return y, counts

        tm.tiered_moe_forward = moe_forward
        self._undo.append(lambda: setattr(tm, "tiered_moe_forward", orig))
        self.prof = None
        # the profiler's first start initializes CUPTI (seconds on the card):
        # pay it here, in set-up, not inside the window
        warm = torch.profiler.profile(activities=self._activities())
        warm.start()
        self._sync()
        warm.stop()

    def _activities(self) -> list:
        acts = [self.torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(self.torch.profiler.ProfilerActivity.CUDA)
        return acts

    def saw_both(self) -> bool:
        """Whether the profiled slice holds a decode and a prefill MoE call."""
        return self.kinds == {True, False}

    def _wrap(self, obj, attr: str, span: str, rf) -> None:
        orig = getattr(obj, attr)

        def wrapped(*a, **kw):
            if span == "decode":
                pos, live = np.asarray(a[1]), kw.get("live")
                live = np.ones(len(pos), bool) if live is None else np.asarray(live, bool)
                self.decode_rows.append((pos[live] + 1, self.profiled))
            elif span == "prefill":
                self.prefill.append((np.asarray(a[3]), np.asarray(a[2]), self.profiled))
            with rf(f"bench.{span}"):
                return orig(*a, **kw)

        setattr(obj, attr, wrapped)
        self._undo.append(lambda: delattr(obj, attr))

    def _sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def start(self) -> None:
        torch = self.torch
        self._sync()
        self.prof = torch.profiler.profile(activities=self._activities())
        self.prof.start()
        self._slice = torch.profiler.record_function("bench.slice")
        self._slice.__enter__()
        self.profiled = True
        self._t_start = time.perf_counter()
        self.steps = 0

    def stop(self) -> None:
        self._sync()
        self.wall_s = time.perf_counter() - self._t_start
        self._slice.__exit__(None, None, None)
        self.prof.stop()
        self.profiled = False

    def close(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo = []


# ---------------------------------------------------------------- the run
def run_cell(bench_dir: Path, cell: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", control: bool = False,
             rate: Optional[float] = None) -> dict:
    """Run `cell` once and return its result line's object (without the
    device's name, which run.py adds). `control` also reads the
    lower-precision control on the same sample;
    `rate` replaces an open loop's rate (the knee sweep)."""
    import torch

    import system
    from devtrace import reduce_events

    spec = load_cell(bench_dir, cell)
    wl, bench = spec["workload"], spec["benchmark"]
    dims = dims_of(spec["model"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        from repro_torch.kernels.build import build_all

        build_all()
    cfg = system.port_config(dims)
    params = system.build_params(dims, cfg, seed, dev)
    loop = system.build_loop(cfg, params, wl["loop"], dev, trace)
    del params  # the engine keeps the stripped tree, the tiers the experts
    load = dict(wl["load"], **({"rate_per_s": rate} if rate else {}))
    traffic = traffic_of(bench_dir, spec["mix"], dims.vocab, seed)

    # warm-up: the cell's prefill shapes on prompts sharing nothing with the traffic
    from repro_torch.serving.batching import Request

    n_warm = max(4, wl["loop"].get("prefill_rows") or 4)
    for i, (prompt, n_new) in enumerate(traffic.warmup(n_warm, 3)):
        loop.submit(Request(rid=-1 - i, prompt=prompt, max_new_tokens=n_new))
    loop.run()

    rate = load.get("rate_per_s")
    drv = LoadGen(loop, traffic, load,
                  gaps_of(bench_dir, spec["mix"], seed, rate) if rate else None)
    drv.start(seed)
    first = list(drv.inflight)
    ramp_end = drv.clock() + float(wl.get("ramp_s", 0.0))
    while drv.first_tokens_pending(first) or drv.clock() < ramp_end:
        drv.step()
    if cuda:
        torch.cuda.synchronize()
    tracing = Tracing(loop, torch, cuda) if trace else None
    st = loop.stats
    before = dict(decode_steps=st.decode_steps, migrations=st.migrations,
                  plan_n=len(st.plan_s), lookup=loop.kv.stats.lookup_tokens,
                  hit=loop.kv.stats.hit_tokens)
    setup_s = time.time() - t_start
    t0 = drv.t0 = drv.clock()
    # the traced slice: SLICE_S from 40% of the window on, and on until it
    # holds a decode and a prefill call (or the window ends)
    slice_at = t0 + 0.4 * seconds
    step_s: List[float] = []
    while drv.clock() - t0 < seconds:
        if tracing is not None and tracing.prof is None and drv.clock() >= slice_at:
            tracing.start()
            slice_end = drv.clock() + min(SLICE_S, 0.3 * seconds)
        dt = drv.step()
        if tracing is not None and tracing.profiled:
            tracing.steps += 1
            if drv.clock() >= slice_end and tracing.saw_both():
                tracing.stop()
        else:
            step_s.append(dt)
    if tracing is not None and tracing.profiled:
        tracing.stop()
    if cuda:
        torch.cuda.synchronize()
    t_end = drv.clock()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    rec = Record(
        dims=dims, setup_s=setup_s, window_s=t_end - t0, tokens=drv.tokens, ttft_s=drv.ttft,
        itl_s=drv.itl, step_s=step_s,
        loop=dict(decode_steps=st.decode_steps - before["decode_steps"],
                  migrations=st.migrations - before["migrations"],
                  lookup_tokens=loop.kv.stats.lookup_tokens - before["lookup"],
                  hit_tokens=loop.kv.stats.hit_tokens - before["hit"]),
        plan_s=list(st.plan_s)[before["plan_n"]:])
    breakdown = None
    if tracing is not None:
        tracing.close()
        rec.moe_calls = [MoECall(d, c.cpu().numpy(), p) for d, c, p in tracing.moe]
        rec.loop["decode_rows"] = sum(len(c) for c, _ in tracing.decode_rows)
        rec.loop["decode_calls"] = len(tracing.decode_rows)
        rec.decode_ctx = [int(x) for c, p in tracing.decode_rows if p for x in c]
        rec.prefill_rows = [(int(a), int(n)) for pasts, lens, p in tracing.prefill if p
                            for a, n in zip(pasts, lens)]
        rec.trace = reduce_events(tracing.prof.events())
        breakdown = {k: rec.trace[k] for k in ("device_ops", "idle_gaps") if k in rec.trace}
        slice_diag = dict(slice_wall_s=tracing.wall_s, slice_steps=tracing.steps,
                          slice_from_s=tracing._t_start - t0)
    q = np.percentile(np.asarray(step_s or [0.0]), [10, 50, 90, 100]) * 1e3
    tails = {f"{k}_p50_90_95_99": (np.percentile(v, [50, 90, 95, 99]).tolist() if v else None)
             for k, v in (("ttft_s", drv.ttft), ("itl_s", drv.itl))}
    diag = dict(**(slice_diag if tracing is not None else {}), **tails,
                step_ms_p10_50_90_max=q.tolist(),
                window_s=rec.window_s, tokens=rec.tokens, requests_first_answered=len(drv.ttft),
                finished=len(drv.finished), sent=drv.sent, steps=len(drv.queue),
                queue_slope_per_s=_queue_slope(drv.queue, t0), queue_last=drv.queue[-1][1],
                rate_per_s=load.get("rate_per_s"), clients=load.get("clients"))
    units = {m["name"]: m["unit"] for m in metrics_for(bench, cell, trace)}
    metrics = {}
    for name, unit in units.items():
        value = reader(bench_dir, name)(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}

    # correctness: free the program, then the reference over a sample
    finished, attempted = drv.finished, drv.sent
    del drv, loop, tracing, st
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, extra = check_outputs(dims, seed, finished, dev, wl["limits"], control)
    diag.update(extra)
    correct = all(c["value"] <= c["limit"] if c.get("at_most", True) else c["value"] >= c["limit"]
                  for c in checks.values())
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": 0,
           "metrics": metrics, "device": {"count": 1, "memory_peak_bytes": int(peak)}}
    if trace and rec.trace:
        out["device"].update(busy_s=rec.trace["busy_s"], window_s=rec.trace["window_s"])
    if breakdown:
        out["breakdown"] = breakdown
    out["diagnostics"] = diag
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return out


def sample_finished(finished: List[tuple], seed: int, target: int) -> List[tuple]:
    """Requests finished in the window, drawn from the seed: the longest
    first, then others in a seeded order until `target` served tokens."""
    if not finished:
        return []
    longest = max(range(len(finished)), key=lambda i: len(finished[i][0]) + len(finished[i][1]))
    order = [longest] + [int(i) for i in np.random.default_rng([int(seed), 11]).permutation(
        len(finished)) if i != longest]
    out, n = [], 0
    for i in order:
        if n >= target:
            break
        out.append(finished[i])
        n += len(finished[i][1])
    return out


def logit_gaps(dims, seed: int, sample: List[tuple], device, quant=None) -> List[float]:
    """For each served token of the sample, how far the float32
    reference's logit of it lies below the reference's best. With
    `quant`, the token is instead the one the lower-precision reference
    puts first at that position (the control)."""
    import torch

    from reference.model import logits_at

    seqs, at, served = [], [], []
    for prompt, gen in sample:
        toks = np.concatenate([prompt, np.asarray(gen[:-1], np.int64)]).astype(np.int64)
        seqs.append(torch.as_tensor(toks))
        at.append(torch.arange(len(prompt) - 1, len(prompt) - 1 + len(gen)))
        served.append(torch.as_tensor(np.asarray(gen, np.int64)))
    ref = logits_at(dims, seed, seqs, at, device)
    if quant is not None:
        low = logits_at(dims, seed, seqs, at, device, quant=quant)
        served = [lg.argmax(-1).cpu() for lg in low]
    gaps = []
    for lg, tok in zip(ref, served):
        best = lg.max(-1).values
        gaps.extend((best - lg.gather(1, tok.to(lg.device)[:, None])[:, 0]).tolist())
    return gaps


def check_outputs(dims, seed: int, finished: List[tuple], device, limits: dict,
                  control: bool) -> tuple:
    from reference.layers import fp8_operands

    sample = sample_finished(finished, seed, CORRECT_SAMPLE_TOKENS)
    t = time.perf_counter()
    gaps = logit_gaps(dims, seed, sample, device) if sample else []
    extra = {"reference_s": time.perf_counter() - t, "sampled_requests": len(sample)}
    if control and sample:
        cgaps = logit_gaps(dims, seed, sample, device, quant=fp8_operands)
        extra["control_max_logit_gap"] = max(cgaps)
        extra["control_mean_logit_gap"] = float(np.mean(cgaps))
    if gaps:
        extra["max_logit_gap"] = max(gaps)
    checks = {
        "mean_logit_gap": {"value": float(np.mean(gaps)) if gaps else math.inf,
                           "limit": limits["mean_logit_gap"]},
        "tokens_compared": {"value": len(gaps), "limit": limits["min_tokens_compared"],
                            "at_most": False},
    }
    return checks, extra


def as_json_line(obj: dict) -> str:
    return json.dumps(obj, separators=(", ", ": "))
