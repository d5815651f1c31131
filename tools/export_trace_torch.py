"""Export observability artifacts from a traced smoke serving replay of the
PyTorch port (counterpart of tools/export_trace.py, with its flags, its
replay and its checks, plus `--device`).

Runs the port's serving loop on a smoke-scale MoE config with
`ObsConfig(trace=True)` and writes three files:

  * a Chrome/Perfetto-loadable `trace_event` JSON with the nested
    step/admit/prefill_chunk/decode/replan/migrate spans; below the
    engine call the port's own: `layer.mixer` per layer (`layer`,
    `kind`), `layer.ffn` per dense FFN, `moe` per tiered MoE call
    (`layer`, `tokens`, `graph`) holding `moe.route`, one `moe.tier` per
    tier and `moe.combine` when it runs eagerly (a decode call replayed
    from a CUDA graph on the card holds none), `model.head`, and a `sync`
    span (`what`) around each host<->device copy that blocks the host; a
    `kernel.<op>` span around
    every kernel op call (the reference's op names, the call's shape;
    `backend` "cuda" on the card, "ref" on the CPU); the
    tier/{experts,predicted_load} counter tracks, and the
    tier_migration / thrash instants;
  * a metrics snapshot JSON: the loop's `MetricsRegistry.snapshot()`
    (serving.* / engine.* / predictor.* on one registry);
  * a Prometheus-style text dump of the same registry.

The replay forces migrations (smoke-scale tier thresholds and
`plan_min=1`) so the scheduler / tier channel is populated, then
validates the exported trace: structural `trace_event` checks, span
containment per track, and the span and instant families below. Exit
status is nonzero on any failure. Runs on the GPU unless `--device cpu`
is given; the weights are random, drawn from seed 0.

  PYTHONPATH=src python tools/export_trace_torch.py --out serving.trace.json
  PYTHONPATH=src python tools/export_trace_torch.py --device cpu
  python tools/export_trace_torch.py --check serving.trace.json

`--check PATH` validates an existing export and needs no device (it
imports the port's trace module only: no torch).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

# script mode: tools/ itself is not a package
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

# span families the exported timeline must carry: the reference's
# (nested step/prefill/decode/replan spans + tier-migration instants),
# then the port's below the engine call (`layer.ffn` only where a layer
# has a dense FFN, which the default granite has not)
REQUIRED_SPANS = ("step", "prefill_chunk", "decode", "replan",
                  "layer.mixer", "moe", "moe.route", "moe.tier", "moe.combine",
                  "model.head", "sync")
REQUIRED_INSTANTS = ("tier_migration",)


def check_trace(path: str) -> int:
    """Validate an exported trace file: well-formed trace_event JSON,
    spans nest per (pid, tid) track, required families present."""
    from repro_torch.obs.trace import load_trace, validate_trace_events

    try:
        events = load_trace(path)
    except (OSError, ValueError) as e:
        print(f"[export_trace_torch] FAIL: cannot load {path}: {e}")
        return 1
    problems = validate_trace_events(events)
    names = {str(e.get("name")) for e in events}
    for want in REQUIRED_SPANS:
        if want not in names:
            problems.append(f"missing required span family '{want}'")
    for want in REQUIRED_INSTANTS:
        if want not in names:
            problems.append(f"missing required instant family '{want}'")
    if not any(n.startswith("kernel.") for n in names):
        problems.append("no kernel.<op> spans on the timeline")
    if problems:
        print(f"[export_trace_torch] FAIL: {path}: {len(problems)} problem(s)")
        for p in problems:
            print(f"[export_trace_torch]   - {p}")
        return 1
    n_spans = sum(1 for e in events if e.get("ph") == "X")
    n_inst = sum(1 for e in events if e.get("ph") == "i")
    n_ctr = sum(1 for e in events if e.get("ph") == "C")
    print(f"[export_trace_torch] ok: {path}: {len(events)} events "
          f"({n_spans} spans, {n_inst} instants, {n_ctr} counter samples), "
          f"{len(names)} distinct names")
    return 0


def run_replay(args) -> int:
    import numpy as np

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core.policy import SchedulerPolicy
    from repro_torch.core.tiers import TierThresholds
    from repro_torch.models.model import init_params, resolve_device
    from repro_torch.obs import ObsConfig
    from repro_torch.serving.batching import Request
    from repro_torch.serving.loop import ServingLoop

    device = resolve_device(args.device)
    cfg = reduce_for_smoke(get_config(args.arch))
    params = init_params(0, cfg, device=device)
    rng = np.random.default_rng(13)
    new_tokens = args.new_tokens
    cache_len = args.prompt_len + 8 + new_tokens + 2

    # smoke-scale thresholds + plan_min=1: per-step expert counts are
    # tiny, so the aggregated-batch defaults would classify everything
    # cold and the tier channel would have nothing to record
    policy = SchedulerPolicy(
        thresholds=TierThresholds(tau_hot=args.tau_hot, tau_cold=args.tau_cold),
        plan_min=1,
    )
    loop = ServingLoop(
        cfg, params, batch_size=args.batch, n_groups=args.groups, cache_len=cache_len,
        obs=ObsConfig(trace=True, trace_path=args.out), scheduler=policy, device=device,
    )
    # mixed prompt lengths so chunked prefill and admission interleave
    # with decode on the timeline
    for i in range(args.requests):
        plen = args.prompt_len + (i % 3) * 4
        loop.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=new_tokens,
        ))
    done = loop.run()
    trace_path = loop.obs.export_trace()
    print(f"[export_trace_torch] device={device} served {len(done)}/{args.requests} "
          f"requests; wrote {trace_path}")

    snap = loop.obs.snapshot()
    with open(args.metrics_json, "w") as f:
        json.dump(snap, f, indent=2, sort_keys=True)
        f.write("\n")
    with open(args.prom, "w") as f:
        f.write(loop.obs.prometheus_text())
    print(f"[export_trace_torch] wrote {args.metrics_json} ({len(snap)} metrics) and "
          f"{args.prom}")
    print(f"[export_trace_torch] serving.tokens_per_s="
          f"{snap.get('serving.tokens_per_s', 0.0):.1f} "
          f"engine.migrations={snap.get('engine.migrations', 0)} "
          f"predictor.accuracy={snap.get('predictor.accuracy', 0.0):.3f}")

    rc = 0
    if len(done) != args.requests:
        print(f"[export_trace_torch] FAIL: incomplete serve ({len(done)}/{args.requests})")
        rc = 1
    return check_trace(trace_path) or rc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", default=None, metavar="PATH",
                    help="validate an existing trace export and exit (no replay)")
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--groups", type=int, default=2)
    ap.add_argument("--tau-hot", type=float, default=6.0,
                    help="hot-tier threshold for the replay policy (smoke-scale)")
    ap.add_argument("--tau-cold", type=float, default=1.0)
    ap.add_argument("--out", default="serving.trace.json",
                    help="trace_event JSON output path (.gitignore'd)")
    ap.add_argument("--metrics-json", default="metrics_snapshot.json",
                    help="MetricsRegistry.snapshot() dump path")
    ap.add_argument("--prom", default="metrics_snapshot.prom",
                    help="Prometheus-style text dump path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the plain PyTorch "
                         "versions of the kernels)")
    args = ap.parse_args(argv)
    if args.check:
        return check_trace(args.check)
    return run_replay(args)


if __name__ == "__main__":
    sys.exit(main())
