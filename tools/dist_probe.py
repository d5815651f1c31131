"""chip_smoke.py's grouped-dispatch `moe_gemm` rows (bf16 and fp32) and its
`distributed` phase alone, on one H100 (~80 s): build the kernels, then
run them. With --profile, instead: torch.profiler over 2 steps of
granite's unsharded train step, then 2 of the mesh step on a (1, 1) NCCL
mesh, twice in turns (each after 2 warm-up steps, one state on the card
at a time), printing wall and device totals and each one's top ops.

  python tools/dist_probe.py [--profile]
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def profile_steps(dev) -> None:
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.training import shard_train_state

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=dev)
    mesh = make_debug_mesh(device_type="cuda")
    cfg = cs.get_config(cs.GQA_ARCH)
    batches = cs._batches(cfg, cs.TRAIN_B, cs.TRAIN_S, dev)
    for name in ("unsharded", "mesh", "unsharded", "mesh"):
        params, opt = cs.init_train_state(0, cfg, cs.TRAIN_OPT, device=dev)
        mesh_arg = None
        if name == "mesh":
            params, opt = shard_train_state(params, opt, mesh, cfg)
            mesh_arg = mesh
        step = cs.make_train_step(cfg, cs.TRAIN_OPT, mesh=mesh_arg)
        for i in range(2):
            params, opt, metrics = step(params, opt, batches[i % 2])
        float(metrics["loss"])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            for i in range(2):
                params, opt, metrics = step(params, opt, batches[i % 2])
            float(metrics["loss"])
            torch.cuda.synchronize()
            wall = time.time() - t0
        dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        print(json.dumps(dict(probe="profile", step=name, wall_s_2_steps=wall,
                              device_busy_s=dev_us / 1e6)), flush=True)
        print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=15),
              flush=True)
        del params, opt, metrics, step, prof
        gc.collect()
        torch.cuda.empty_cache()
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build.build_all()
    if args.profile:
        profile_steps(dev)
        return
    gen = torch.Generator().manual_seed(0)
    for name, label, make, kw in cs.KERNEL_CASES:
        if label in (cs.GROUPED_GU, cs.GROUPED_DOWN):
            for dtype in (torch.bfloat16, torch.float32):
                print(json.dumps(cs.run_case(name, label, make, dtype, kw, dev, gen)),
                      flush=True)
    print(cs.distributed_phase(dev), flush=True)


if __name__ == "__main__":
    main()
