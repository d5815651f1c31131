"""The partitioned mesh train step on several cards (NCCL), one process a
card under torchrun:

  torchrun --nproc-per-node 4 tools/mesh_train_probe.py [--out FILE]
  torchrun --nproc-per-node 4 tools/mesh_train_probe.py --device cpu  # gloo, parity only

Rank 0 builds the kernels, then every rank runs:
- parity: fp32 smoke configs of each assigned arch group, 2 steps of the
  mesh step on (2, 2) (or (1, 4)) against the unsharded step of the same
  global batch on the rank's own card (kernels on both: `moe_gemm` for
  the experts); the losses and every param and moment leaf within the
  CPU parity tests' tolerances (tests/test_torch_training.py: params atol
  = rtol = 1e-5, losses and moments atol 1e-5, rtol 1e-4), reported as
  the worst error over its tolerance; fails past 1;
- timing: granite-moe-1b-a400m at published width and depth, bf16, the
  train phase's 8 x 512 batch and AdamW, 4 steps of the mesh step on (2,
  2) under the MoE hints, then 4 of the unsharded step on each card:
  median step seconds and peak GB of each (reported, not held).
Rank 0 prints one JSON line per case (and writes them to FILE)."""
import argparse
import dataclasses
import datetime
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.data.pipeline import SyntheticCorpus  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.models.moe import set_moe_sharding_hints  # noqa: E402
from repro_torch.training import (  # noqa: E402
    AdamWConfig,
    adamw_init,
    make_train_step,
    shard_train_state,
)
from repro_torch.tree import leaves_with_path  # noqa: E402

DENSE = ("llama3.2-3b", "phi4-mini-3.8b", "qwen2.5-32b", "chameleon-34b", "granite-20b")
# name -> (arch, mesh shape, MoE hints and sequence parallelism, FSDP, config fields)
CASES = {
    "granite-moe": ("granite-moe-1b-a400m", (2, 2), True, False, ()),
    "llama3.2-3b": ("llama3.2-3b", (2, 2), False, False, ()),
    "granite-20b/fsdp": ("granite-20b", (2, 2), False, True, ()),
    "phi4-mini/1x4": ("phi4-mini-3.8b", (1, 4), True, False, (("vocab_size", 258),)),
    "deepseek": ("deepseek-v2-236b", (2, 2), True, False, ()),
    "jamba": ("jamba-v0.1-52b", (2, 2), True, False, ()),
    "xlstm": ("xlstm-125m", (2, 2), False, False, ()),
    "xlstm/dh/1x4": ("xlstm-125m", (1, 4), False, False, (("n_heads", 2), ("n_kv_heads", 2))),
    "seamless": ("seamless-m4t-large-v2", (2, 2), False, False, ()),
}
B, S, STEPS = 4, 32, 2
ATOL, RTOL, P_ATOL, P_RTOL = 1e-5, 1e-4, 1e-5, 1e-5


def smoke_cfg(arch: str, config: tuple):
    cfg = reduce_for_smoke(get_config(arch))
    if arch in DENSE:
        cfg = cs.keep_groups(cfg, get_config(arch))
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32",
                               **dict(config))


def batches(cfg, n: int, dev) -> list:
    out = []
    for i in range(n):
        b = {k: torch.as_tensor(v).to(dev)
             for k, v in SyntheticCorpus(cfg.vocab_size, seed=0).batch(i, B, S).items()}
        if cfg.encdec is not None:
            rng = np.random.default_rng(100 + i)
            b["frames"] = torch.as_tensor(rng.standard_normal(
                (B, cfg.encdec.frontend_frames, cfg.d_model)) * 0.02,
                dtype=torch.float32).to(dev)
        out.append(b)
    return out


def parity(name: str, dev) -> dict:
    arch, shape, hints, fsdp, config = CASES[name]
    cfg = smoke_cfg(arch, config)
    opt_cfg = AdamWConfig(grad_clip=0.1)
    data = batches(cfg, STEPS, dev)
    params = init_params(0, cfg, device=dev)
    plain = make_train_step(cfg, opt_cfg)
    p, o = params, adamw_init(params, opt_cfg)
    want = []
    for b in data:
        p, o, m = plain(p, o, b)
        want.append(float(m["loss"]))
    mesh = make_mesh(shape, ("data", "model"), dev.type)
    set_moe_sharding_hints(enable=hints)
    att.set_sequence_parallel(mesh if hints else None)
    threshold = shd.FSDP_THRESHOLD
    if fsdp:  # the smoke config far below it: store it as a large arch's
        shd.FSDP_THRESHOLD = 0
    mp, mo = shard_train_state(params, adamw_init(params, opt_cfg), mesh, cfg)
    shd.FSDP_THRESHOLD = threshold
    step = make_train_step(cfg, opt_cfg, mesh=mesh)
    got = []
    t0 = time.time()
    for b in data:
        mp, mo, m = step(mp, mo, b)
        got.append(float(m["loss"]))
    secs = time.time() - t0
    set_moe_sharding_hints(enable=False)
    att.set_sequence_parallel(None)
    worst, where = max(abs(a - b) / (ATOL + RTOL * abs(b)) for a, b in zip(got, want)), "loss"
    for part, (a_t, b_t), (atol, rtol) in (("param", (mp, p), (P_ATOL, P_RTOL)),
                                           ("m", (mo["m"], o["m"]), (ATOL, RTOL)),
                                           ("v", (mo["v"], o["v"]), (ATOL, RTOL))):
        for (path, a), (_, w) in zip(leaves_with_path(a_t), leaves_with_path(b_t)):
            over = float(((a.full_tensor() - w).abs() / (atol + rtol * w.abs())).max())
            if over > worst:
                worst, where = over, f"{part} {'/'.join(path)}"
    return dict(probe="parity", case=name, mesh=list(shape), losses=got, unsharded_losses=want,
                err_over_tol=worst, worst_at=where, seconds_2_steps=secs, ok=worst <= 1.0)


def timing(dev, cfg) -> dict:
    data = cs._batches(cfg, cs.TRAIN_B, cs.TRAIN_S, dev)
    out = {}
    for name in ("mesh", "unsharded"):
        params, opt = cs.init_train_state(0, cfg, cs.TRAIN_OPT, device=dev)
        mesh = None
        if name == "mesh":
            mesh = make_mesh((2, 2), ("data", "model"), dev.type)
            params, opt = shard_train_state(params, opt, mesh, cfg)
        set_moe_sharding_hints(enable=mesh is not None)
        step = make_train_step(cfg, cs.TRAIN_OPT, mesh=mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        secs, losses = [], []
        for i in range(4):
            t0 = time.time()
            params, opt, m = step(params, opt, data[i % 2])
            losses.append(float(m["loss"]))
            secs.append(time.time() - t0)
        set_moe_sharding_hints(enable=False)
        out[f"{name}_step"] = dict(
            step_s=secs, median_step_s=sorted(secs[1:])[1], losses=losses,
            peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None)
        del params, opt, m, step
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return dict(probe="timing", arch=cfg.name, batch=cs.TRAIN_B, seq=cs.TRAIN_S,
                mesh=[2, 2], **out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    rank, local = int(os.environ["RANK"]), int(os.environ["LOCAL_RANK"])
    timeout = datetime.timedelta(seconds=300)
    if args.device == "cpu":
        dev = torch.device("cpu")
        dist.init_process_group("gloo", timeout=timeout)
    else:
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("nccl", device_id=dev, timeout=timeout)
        if rank == 0:
            cs.build.build_all()
        dist.barrier()
    out = Path(args.out) if args.out and rank == 0 else None
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("")

    def record(rec: dict) -> None:
        if rank == 0:
            print(json.dumps(rec), flush=True)
            if out is not None:
                with out.open("a") as f:
                    f.write(json.dumps(rec) + "\n")

    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()
        record(dict(probe="cards", nvidia_smi=smi, world=dist.get_world_size()))
    ok = True
    for name in CASES:
        rec = parity(name, dev)
        ok = ok and rec["ok"]
        record(rec)
    # granite at published width on the card; its smoke config on the CPU
    cfg = get_config(cs.GQA_ARCH)
    record(timing(dev, cfg if dev.type == "cuda" else reduce_for_smoke(cfg)))
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
