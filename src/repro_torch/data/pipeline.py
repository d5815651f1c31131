"""Deterministic, shardable token data pipeline (a copy of
repro/data/pipeline.py, numpy only: batches equal the reference's
bitwise).

Two sources behind one interface:
  SyntheticCorpus — seeded Zipf-over-vocab token stream with Markov
    structure (enough signal for the loss to fall in examples);
  FileCorpus — memory-mapped uint16/uint32 token file (real corpora).

Batches are deterministic functions of (seed, step, host_id), so every
host of a 1000-node job computes its own shard without coordination and
a restart at step N reproduces the exact same batch N (bitwise) —
required for clean checkpoint-resume semantics.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


class SyntheticCorpus:
    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab_size = vocab_size
        self.seed = seed

    def batch(self, step: int, batch: int, seq: int, host: int = 0, n_hosts: int = 1):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host])
        )
        local = batch // n_hosts
        # Markov-ish stream: next token = prev mixed with Zipf draw
        zipf = rng.zipf(1.3, size=(local, seq + 1)) % self.vocab_size
        roll = np.roll(zipf, 1, axis=1)
        mix = rng.random((local, seq + 1)) < 0.3
        toks = np.where(mix, roll, zipf).astype(np.int32)
        return {"tokens": toks[:, :seq], "labels": toks[:, 1:]}


class FileCorpus:
    def __init__(self, path: str, vocab_size: int, dtype=np.uint16, seed: int = 0):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.vocab_size = vocab_size
        self.seed = seed

    def batch(self, step: int, batch: int, seq: int, host: int = 0, n_hosts: int = 1):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host])
        )
        local = batch // n_hosts
        n = len(self.data) - seq - 1
        starts = rng.integers(0, n, size=local)
        toks = np.stack(
            [np.asarray(self.data[s : s + seq + 1], np.int32) for s in starts]
        )
        toks = np.clip(toks, 0, self.vocab_size - 1)
        return {"tokens": toks[:, :seq], "labels": toks[:, 1:]}


@dataclass
class DataConfig:
    source: str = "synthetic"  # synthetic | file
    path: Optional[str] = None
    seed: int = 0


def make_corpus(cfg: DataConfig, vocab_size: int):
    if cfg.source == "file":
        return FileCorpus(cfg.path, vocab_size, seed=cfg.seed)
    return SyntheticCorpus(vocab_size, seed=cfg.seed)


def add_frames(batch: Dict, cfg, rng_seed: int = 0):
    """Frontend stub for [audio]/[vlm] archs: deterministic precomputed
    frame/patch embeddings (spec: modality frontends are stubs)."""
    if cfg.encdec is not None:
        rng = np.random.default_rng(rng_seed)
        b = batch["tokens"].shape[0]
        batch["frames"] = rng.standard_normal(
            (b, cfg.encdec.frontend_frames, cfg.d_model)
        ).astype(np.float32) * 0.02
    return batch
