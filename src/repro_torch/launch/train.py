"""End-to-end training driver of the port (counterpart of
repro/launch/train.py): seeded random init, the deterministic data
pipeline, AdamW, async checkpointing with auto-resume, a straggler
watchdog and a preemption handler. Runs on the GPU unless `--device cpu`
is given. One process by default; under `torchrun` it joins the process
group (NCCL on cards, gloo with `--device cpu`), builds the debug mesh
over the world and, when the mesh has more than one device, stores the
train state sharded on it and runs the mesh train step. An
encoder-decoder model's frames (`add_frames`, fp32) are cast to the
params' dtype: repro/launch/train.py passes them as they are, and its
scanned decoder then raises a TypeError at bf16.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
      --smoke --steps 10 --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --smoke --steps 10 --device cpu
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.pipeline import DataConfig, add_frames, make_corpus
from repro_torch.distributed.fault_tolerance import (
    ElasticPolicy,
    StepWatchdog,
    install_preemption_handler,
)
from repro_torch.distributed.sharding import named_shardings, opt_state_pspecs, tree_pspecs
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import resolve_device
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import (
    init_train_state,
    make_train_step,
    shard_train_state,
)


def _join_world(device: torch.device) -> torch.device:
    """Under torchrun: join the process group (NCCL on cards, gloo on the
    CPU) and return this rank's device."""
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return device


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
    mesh = None
    if "WORLD_SIZE" in os.environ:  # launched by torchrun
        device = _join_world(device)
        mesh = make_debug_mesh(device_type=device.type)
        if mesh.size() == 1:
            mesh = None
    log = not dist.is_initialized() or dist.get_rank() == 0
    opt_cfg = AdamWConfig(lr=args.lr, compression=args.compression,
                          warmup_steps=max(1, args.steps // 10))
    params, opt_state = init_train_state(0, cfg, opt_cfg, device=device)
    shardings = None
    if mesh is not None:
        params, opt_state = shard_train_state(params, opt_state, mesh, cfg)
        specs = tree_pspecs(params, mesh, cfg)
        shardings = {"params": named_shardings(mesh, specs),
                     "opt": named_shardings(mesh, opt_state_pspecs(opt_state, specs))}
    step_fn = make_train_step(cfg, opt_cfg, args.microbatches, mesh=mesh)

    corpus = make_corpus(DataConfig(), cfg.vocab_size)
    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt is not None:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            if log:
                print(f"[train] auto-resume from step {last}")
            state = restore(args.ckpt_dir, last, {"params": params, "opt": opt_state},
                            shardings)
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
        if watchdog.observe(step, dt) and log:
            print(f"[train] step {step}: straggler ({dt:.2f}s)")
            if elastic.should_reshard(watchdog, step):
                print("[train] elastic policy: would evict slow host + "
                      "reshard from last checkpoint")
        if step % args.log_every == 0 and log:
            print(f"[train] step {step} loss={loss:.4f} ce={float(metrics['ce']):.4f} "
                  f"dt={dt:.2f}s")
        if ckpt is not None and step and step % args.ckpt_every == 0:
            ckpt.save_async(step, {"params": params, "opt": opt_state})
    if ckpt is not None:
        ckpt.wait()
    if log:
        print(f"[train] done. first loss={losses[0]:.4f} last loss={losses[-1]:.4f}")
    if dist.is_initialized():
        dist.destroy_process_group()
    return losses


if __name__ == "__main__":
    main()
