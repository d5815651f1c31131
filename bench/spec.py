"""A configuration file of `bench/configs/` read into the dimensions the
benchmark's own code needs (the weights generator, the plain reference,
the FLOP and byte counts), and the loader that finds a part of the
benchmark by name. Imports nothing of the program.

A configuration's model family is the module `bench/families/<model_type>.py`
of its file's `model_type`. The family reads the file into `Dims` (or a
subclass of it) with `dims_of(cfg)`; it may also give `layer_spec`,
`reference_layer` and `layer_token_flops`, which otherwise default to the
shared pieces in `weights.py`, `reference/layers.py` and `roofline.py`.

A file states the source's keys as published. Where the program runs a
mechanism otherwise, the file's `runs_as` group gives the value it runs
with, and `dims_of` reads that value in place of the published one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, Tuple

BENCH = Path(__file__).resolve().parent
FAMILIES = BENCH / "families"

Sig = Tuple[str, str]  # (mixer, ffn): mixer in mla | attn | mamba; ffn in dense | moe


@dataclasses.dataclass(frozen=True)
class Dims:
    name: str
    model_type: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab: int
    d_ff: int  # the dense FFN's width
    norm_eps: float
    rope_theta: float
    dtype: str  # the served parameter dtype: "bfloat16" | "float32"
    sigs: Tuple[Sig, ...]
    # routed experts
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int
    norm_topk_prob: bool
    # MLA
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # Mamba
    d_state: int = 0
    d_conv: int = 0
    expand: int = 0
    dt_rank: int = 0
    attn_period: int = 0  # jamba: one attention layer in this many

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


_MODULES: Dict[Path, ModuleType] = {}


def module_at(path: Path) -> ModuleType:
    """The Python file at `path`, loaded once (a metric's reader, a traffic
    generator, an arrival process, a model family or its port)."""
    path = Path(path).resolve()
    if path not in _MODULES:
        if not path.is_file():
            raise FileNotFoundError(f"no module {path}")
        name = "bench_" + "_".join(path.relative_to(path.parents[1]).with_suffix("").parts)
        name = name.replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod  # dataclasses look their module up by name
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def family(model_type: str) -> ModuleType:
    """The model family module of `model_type`."""
    return module_at(FAMILIES / f"{model_type}.py")


def as_run(cfg: dict) -> dict:
    """The file's keys with the values the program runs with (`runs_as`)."""
    return {**cfg, **cfg.get("runs_as", {})}


def dims_of(cfg: dict) -> Dims:
    """The dimensions of a configuration file's JSON object."""
    return family(cfg["model_type"]).dims_of(as_run(cfg))


def common_dims(cfg: dict) -> dict:
    """The keys every family reads alike, as `Dims` fields."""
    return dict(
        name=cfg["name"], model_type=cfg["model_type"], n_layers=int(cfg["num_hidden_layers"]),
        d_model=int(cfg["hidden_size"]), n_heads=int(cfg["num_attention_heads"]),
        n_kv_heads=int(cfg["num_key_value_heads"]), vocab=int(cfg["vocab_size"]),
        d_ff=int(cfg["intermediate_size"]), norm_eps=float(cfg["rms_norm_eps"]),
        dtype=cfg["served_dtype"], norm_topk_prob=bool(cfg.get("norm_topk_prob", False)),
    )
