"""Quickstart of the PyTorch port: build a model from a pool config, train
a few steps, then prefill + decode, at smoke scale (counterpart of
examples/quickstart.py). Runs on the GPU unless `--device cpu` is given.

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.models.model import decode_step, init_params, prefill, resolve_device
from repro_torch.training import AdamWConfig, adamw_init, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the GPU; 'cpu' runs on the CPU")
    device = resolve_device(ap.parse_args(argv).device)
    cfg = reduce_for_smoke(get_config("llama3.2-3b"))
    print(f"arch={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"params={cfg.param_count()/1e6:.1f}M device={device}")

    params = init_params(0, cfg, device=device)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=5)
    opt = adamw_init(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg)

    corpus = SyntheticCorpus(cfg.vocab_size)
    for i in range(10):
        batch = {k: torch.as_tensor(v, device=device) for k, v in corpus.batch(i, 4, 32).items()}
        params, opt, m = step(params, opt, batch)
        print(f"step {i}: loss={float(m['loss']):.4f}")

    # generate a few tokens
    prompt = torch.as_tensor(corpus.batch(99, 1, 8)["tokens"], device=device)
    with torch.no_grad():
        _, cache = prefill(params, cfg, prompt, cache_len=16)
        tok = prompt[:, -1:]
        out = []
        for i in range(8):
            logits, cache, _ = decode_step(params, cfg, tok, cache, 8 + i)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            out.append(int(tok[0, 0]))
    print("generated token ids:", out)


if __name__ == "__main__":
    main()
