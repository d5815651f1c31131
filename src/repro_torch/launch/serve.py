"""End-to-end serving driver of the port (counterpart of
repro/launch/serve.py): queued requests with staggered prompt lengths
stream through the paged, chunked-prefill TriMoE serving loop, with
expert migrations replanned between group steps. Weights are random,
drawn from `--seed`. Runs on the GPU unless `--device cpu` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m \\
      --smoke --requests 8 --batch 4 --groups 2 --new-tokens 16 --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models.model import init_params, resolve_device
from repro_torch.serving.batching import Request
from repro_torch.serving.loop import ServingLoop


def build_loop(cfg, *, batch: int, groups: int, cache_len: int,
               cold_capacity_frac: float = 1.0, seed: int = 0,
               bucket_table="auto", max_admit_wait: int = 4,
               device=None) -> ServingLoop:
    device = resolve_device(device)
    params = init_params(seed, cfg, device=device)
    return ServingLoop(
        cfg, params,
        batch_size=batch, n_groups=groups, cache_len=cache_len,
        cold_capacity_frac=cold_capacity_frac,
        bucket_table=bucket_table, max_admit_wait=max_admit_wait,
        device=device,
    )


def make_requests(cfg, n: int, prompt_len: int, new_tokens: int,
                  stagger: int = 0, seed: int = 0):
    """n requests; with `stagger`, prompt lengths cycle over the
    inclusive range [prompt_len, prompt_len + stagger]."""
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n):
        plen = prompt_len + (rid % (stagger + 1))
        reqs.append(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=new_tokens,
        ))
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--groups", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--stagger", type=int, default=3)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--no-buckets", action="store_true",
                    help="exact-length prefill instead of the default "
                         "length-bucketed masked prefill")
    ap.add_argument("--max-admit-wait", type=int, default=4,
                    help="admit a partial same-bucket cohort after this many "
                         "admission rounds (starvation cap)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    assert cfg.moe is not None, "serve.py drives the TriMoE MoE path"

    cache_len = args.prompt_len + args.stagger + args.new_tokens
    loop = build_loop(cfg, batch=args.batch, groups=args.groups,
                      cache_len=cache_len, seed=args.seed,
                      bucket_table=None if args.no_buckets else "auto",
                      max_admit_wait=args.max_admit_wait, device=args.device)
    for r in make_requests(cfg, args.requests, args.prompt_len,
                           args.new_tokens, stagger=args.stagger, seed=args.seed):
        loop.submit(r)

    done = loop.run()
    eng = loop.engine
    print(f"[serve] device={loop.device} {loop.stats.summary()}")
    print(f"[serve] migrations={eng.stats.migrations} plans={eng.stats.plans} "
          f"prefills={eng.stats.prefills} "
          f"predictor_acc={eng.predictor.stats.accuracy:.2f} "
          f"prefix_hit_rate={loop.kv.stats.hit_rate:.3f}")
    buckets = (list(loop.bucket_table.widths)
               if loop.bucket_table is not None else "off")
    print(f"[serve] buckets={buckets}")
    for r in done[: min(4, len(done))]:
        print(f"[serve]   rid={r.rid} prompt_len={r.prompt_len} "
              f"tokens={r.generated[:8]}{'...' if len(r.generated) > 8 else ''}")
    return loop.stats.generated_tokens


if __name__ == "__main__":
    main()
