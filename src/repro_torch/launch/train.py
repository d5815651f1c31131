"""End-to-end single-device training driver of the port (counterpart of
repro/launch/train.py): seeded random init, the deterministic data
pipeline, AdamW, async checkpointing with auto-resume, a straggler
watchdog and a preemption handler. Runs on the GPU unless `--device cpu`
is given. The reference's device mesh and sharded state are the
distributed slice's. An encoder-decoder model's frames (`add_frames`,
fp32) are cast to the params' dtype: repro/launch/train.py passes them
as they are, and its scanned decoder then raises a TypeError at bf16.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
      --smoke --steps 10 --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.pipeline import DataConfig, add_frames, make_corpus
from repro_torch.distributed.fault_tolerance import (
    ElasticPolicy,
    StepWatchdog,
    install_preemption_handler,
)
from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import resolve_device
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none", choices=["none", "bf16", "int8_ef"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="default: the GPU; 'cpu' runs the "
                    "kernels' plain PyTorch versions on the CPU")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    device = resolve_device(args.device)
    opt_cfg = AdamWConfig(lr=args.lr, compression=args.compression,
                          warmup_steps=max(1, args.steps // 10))
    params, opt_state = init_train_state(0, cfg, opt_cfg, device=device)
    step_fn = make_train_step(cfg, opt_cfg, args.microbatches)

    corpus = make_corpus(DataConfig(), cfg.vocab_size)
    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt is not None:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            print(f"[train] auto-resume from step {last}")
            state = restore(args.ckpt_dir, last, {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start = last
        install_preemption_handler(
            lambda: ckpt.save_async(start, {"params": params, "opt": opt_state})
        )

    watchdog = StepWatchdog()
    elastic = ElasticPolicy()
    losses = []
    for step in range(start, args.steps):
        batch = add_frames(corpus.batch(step, args.batch, args.seq), cfg)
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        if "frames" in batch:  # the frontend stub's fp32 frames, in the params' dtype
            batch["frames"] = batch["frames"].to(torch_dtype(cfg.param_dtype))
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])  # synchronises with the device
        dt = time.time() - t0
        losses.append(loss)
        if watchdog.observe(step, dt):
            print(f"[train] step {step}: straggler ({dt:.2f}s)")
            if elastic.should_reshard(watchdog, step):
                print("[train] elastic policy: would evict slow host + "
                      "reshard from last checkpoint")
        if step % args.log_every == 0:
            print(f"[train] step {step} loss={loss:.4f} ce={float(metrics['ce']):.4f} "
                  f"dt={dt:.2f}s")
        if ckpt is not None and step and step % args.ckpt_every == 0:
            ckpt.save_async(step, {"params": params, "opt": opt_state})
    if ckpt is not None:
        ckpt.wait()
    print(f"[train] done. first loss={losses[0]:.4f} last loss={losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
