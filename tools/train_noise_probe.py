"""How far rounding-sized noise moves a two-step fp32 train state.

Trains the fp32 smoke granite-moe-1b-a400m config for two steps on the
CPU from its seed-0 weights and again from the same weights times
(1 + 1.2e-7 * N(0, 1)) (about one fp32 rounding each), and prints the
three leaves farthest apart, as chip_smoke.py's `train_smoke_parity`
measures them (|a - b| over 1e-5 * (|b| + the leaf's largest |b|)): of
the first step's gradients, and of the state after two steps of AdamW
at lr 1e-3 with 2 warm-up steps (the train phase's) and at its defaults
(lr 3e-4, 100 warm-up steps). Adam divides each moment by its
own magnitude, so an element whose gradient is near 0 moves by up to lr
for a rounding-sized change of that gradient: the card-vs-CPU
comparison of a train state has to be read against this.

  PYTHONPATH=src python tools/train_noise_probe.py
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.models.model import init_params
from repro_torch.training import AdamWConfig, adamw_init, make_train_step, value_and_grad
from repro_torch.tree import leaves_with_path, tree_map


def farthest(got, want) -> list:
    """The three leaves of `got` farthest from `want`'s: (err / tol, path)."""
    ref = dict(leaves_with_path(want))
    worst = []
    for path, leaf in leaves_with_path(got):
        w = ref[path].float()
        tol = 1e-5 * (w.abs() + w.abs().max())
        r = (leaf.float() - w).abs() / tol.clamp_min(1e-30)
        worst.append((float(r.max()), "|".join(map(str, path))))
    return sorted(worst, reverse=True)[:3]


def main() -> None:
    cfg = dataclasses.replace(reduce_for_smoke(get_config("granite-moe-1b-a400m")),
                              param_dtype="float32", compute_dtype="float32")
    params = init_params(0, cfg, device="cpu")
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    batches = [{k: torch.as_tensor(v) for k, v in corpus.batch(i, 4, 32).items()}
               for i in range(2)]
    gen = torch.Generator().manual_seed(1)
    noisy = tree_map(lambda p: p * (1 + 1.2e-7 * torch.randn(p.shape, generator=gen)), params)
    grads = [value_and_grad(p, cfg, batches[0])[2] for p in (params, noisy)]
    print(f"first step's gradients: err / tol of the farthest leaves "
          f"{farthest(grads[1], grads[0])}")
    for opt in (AdamWConfig(lr=1e-3, warmup_steps=2), AdamWConfig()):
        states = []
        for p in (params, noisy):
            o = adamw_init(p, opt)
            step = make_train_step(cfg, opt)
            for batch in batches:
                p, o, _ = step(p, o, batch)
            states.append({"params": p, "opt": o})
        print(f"lr {opt.lr} warm-up {opt.warmup_steps}: err / tol of the farthest leaves "
              f"{farthest(states[1], states[0])}")


if __name__ == "__main__":
    main()
