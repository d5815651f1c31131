"""Architecture registry.

``get_config("<arch-id>")`` accepts the exact pool id (dots/dashes) or the
underscored module name. ``ASSIGNED`` lists the 10 graded architectures in
pool order; ``SIM_WORKLOADS`` are the paper-Table-2 models used only by the
TriMoE simulator benchmarks.
"""
from __future__ import annotations

from repro_torch.configs import (
    chameleon_34b,
    deepseek_v2_236b,
    glm_4_5_air,
    granite_20b,
    granite_moe_1b_a400m,
    jamba_v0_1_52b,
    llama3_2_3b,
    phi4_mini_3_8b,
    qwen2_5_32b,
    qwen3_235b_a22b,
    seamless_m4t_large_v2,
    xlstm_125m,
)
from repro_torch.configs.base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    EncDecConfig,
    MambaConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    ShapeSpec,
    XLSTMConfig,
    reduce_for_smoke,
    shape_applicable,
)

ASSIGNED: tuple[str, ...] = (
    "jamba-v0.1-52b",
    "chameleon-34b",
    "granite-20b",
    "phi4-mini-3.8b",
    "qwen2.5-32b",
    "llama3.2-3b",
    "xlstm-125m",
    "seamless-m4t-large-v2",
    "deepseek-v2-236b",
    "granite-moe-1b-a400m",
)

SIM_WORKLOADS: tuple[str, ...] = (
    "deepseek-v2-236b",
    "qwen3-235b-a22b",
    "glm-4.5-air",
)

_REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        jamba_v0_1_52b,
        chameleon_34b,
        granite_20b,
        phi4_mini_3_8b,
        qwen2_5_32b,
        llama3_2_3b,
        xlstm_125m,
        seamless_m4t_large_v2,
        deepseek_v2_236b,
        granite_moe_1b_a400m,
        qwen3_235b_a22b,
        glm_4_5_air,
    )
}


def _canon(name: str) -> str:
    return name.replace("_", "-").replace(".", "-").lower()


_CANON = {_canon(k): k for k in _REGISTRY}


def get_config(name: str) -> ModelConfig:
    if name in _REGISTRY:
        return _REGISTRY[name]
    c = _canon(name)
    if c in _CANON:
        return _REGISTRY[_CANON[c]]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")


def list_archs() -> list[str]:
    return list(ASSIGNED)


def get_shape(name: str) -> ShapeSpec:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; known: {[s.name for s in ALL_SHAPES]}")


def cells(include_inapplicable: bool = False):
    """Yield every (arch, shape[, reason]) dry-run cell."""
    for a in ASSIGNED:
        cfg = get_config(a)
        for s in ALL_SHAPES:
            ok, why = shape_applicable(cfg, s)
            if ok:
                yield (a, s.name)
            elif include_inapplicable:
                yield (a, s.name, why)


__all__ = [
    "ALL_SHAPES", "ASSIGNED", "SIM_WORKLOADS", "DECODE_32K", "LONG_500K",
    "PREFILL_32K", "TRAIN_4K", "EncDecConfig", "MambaConfig", "MLAConfig",
    "ModelConfig", "MoEConfig", "ShapeSpec", "XLSTMConfig", "cells",
    "get_config", "get_shape", "list_archs", "reduce_for_smoke",
    "shape_applicable",
]
