"""Reproduce the paper's headline comparison with the PyTorch port's copy
of the analytic model (`repro_torch.core`): DeepSeek-V2 decode at batch
512 across Klotski / En-KTransformers / MoNDE / TriMoE, plus the
ablation chain. It prints the same lines as examples/simulate_paper.py.

Every time it prints is MODELLED for the paper's Table-1 system (an H100
PCIe, an AMX CPU and 16 DIMM-NDPs, `repro_torch/hardware.py`) by the
event-level simulator. None is a measurement on a GPU, a TPU or the CPU
it runs on. numpy only: no device is used.

  PYTHONPATH=src python examples/simulate_paper_torch.py [--batch 512]
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.core import simulate
from repro_torch.core.simulator import SimFlags


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--model", default="deepseek-v2-236b")
    args = ap.parse_args()

    cfg = get_config(args.model)
    print(f"== {cfg.name}, batch {args.batch} (zigzag/offline aggregated) ==")
    results = {}
    for pol in ("klotski", "enkt", "monde", "trimoe"):
        r = simulate(cfg, args.batch, policy=pol, n_steps=args.steps)
        results[pol] = r
        u = r.utils
        print(f"{pol:8s} MoE-layer {1e3 * r.moe_time / (r.n_steps):7.1f} ms/step "
              f"| e2e {r.throughput:7.1f} tok/s "
              f"| util gpu/cpu/ndp {u['gpu']:.2f}/{u['cpu']:.2f}/{u['ndp']:.2f}")
    best = min(results[p].moe_time for p in ("klotski", "enkt", "monde"))
    print(f"\nTriMoE decode speedup vs best baseline: "
          f"{best / results['trimoe'].moe_time:.2f}x (paper: 2.12-2.83x)")

    print("\n== ablation (paper Fig. 8) ==")
    base = simulate(cfg, args.batch, policy="gpu_ndp", n_steps=args.steps)
    cpu = simulate(cfg, args.batch, flags=SimFlags(
        policy="trimoe", enable_refinement=False, enable_relayout=False),
        n_steps=args.steps)
    ref = simulate(cfg, args.batch, flags=SimFlags(
        policy="trimoe", enable_refinement=True, enable_relayout=False),
        n_steps=args.steps)
    rel = simulate(cfg, args.batch, flags=SimFlags(
        policy="trimoe", enable_refinement=True, enable_relayout=True),
        n_steps=args.steps)
    print(f"+CPU        {base.moe_time / cpu.moe_time:.2f}x (paper 1.75x)")
    print(f"+Refinement {cpu.moe_time / ref.moe_time:.2f}x (paper 1.28x)")
    print(f"+Relayout   {ref.moe_time / rel.moe_time:.2f}x (paper 1.16x)")
    print(f"\npredictor: migration accuracy {rel.migration_accuracy:.2f} "
          f"(paper >0.78), metadata {rel.predictor_bytes / 1e3:.1f} KB (paper 38 KB)")
    print(f"migration overhead {100 * rel.migration_overhead / rel.step_time:.2f}% "
          f"(paper <3.3%)")


if __name__ == "__main__":
    main()
