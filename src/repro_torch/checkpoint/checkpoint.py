"""Checkpointing: async, atomic (port of repro/checkpoint/checkpoint.py,
same format).

One `step_XXXXXXXX/state.npz` per checkpoint step holding every tree
leaf keyed by its tree path (`a|b|c`, named as JAX's
`tree_flatten_with_path` names it), plus a small JSON manifest. bf16
leaves are stored as fp32 (npz has no bf16) and cast back on restore, so
either package restores the other's checkpoints. Writes go to
`<dir>/tmp.<step>` and are committed with an atomic rename: a crash
mid-write never corrupts the latest checkpoint. `AsyncCheckpointer`
makes the host copies on the caller's thread and writes them on a
background thread, so the train loop never blocks on the filesystem.

A state stored as DTensors on a device mesh is saved whole: every rank
gathers each leaf (a collective, so every rank calls `save`) and rank 0
writes. `restore(..., shardings=)` places each leaf on a mesh, which may
differ from the one it was saved from (an elastic restart): every rank
reads the file and keeps its own chunk.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import leaves_with_path, unflatten

Params = Any
_SEP = "|"


def _key(path) -> str:
    return _SEP.join(str(k) for k in path)


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bf16 as fp32 (a lossless superset)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if hasattr(t, "full_tensor"):  # a DTensor: gathered whole
            t = t.full_tensor()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(leaf)


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0, or a lone process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save(ckpt_dir: str, step: int, tree: Params, manifest: Optional[dict] = None) -> str:
    """Write checkpoint `step`. Under a process group every rank calls it
    and returns once rank 0 has committed the write."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    arrays = {_key(path): _host(leaf) for path, leaf in leaves_with_path(tree)}
    if _writes():
        _write(ckpt_dir, step, arrays, manifest)
    if dist.is_initialized():
        dist.barrier()
    return final


def _write(ckpt_dir: str, step: int, arrays: dict, manifest: Optional[dict]) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "state.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, **(manifest or {})}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit


class AsyncCheckpointer:
    """Host copies on the caller's thread, the write on a background
    thread; `wait()` joins it before the next save or exit."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save_async(self, step: int, tree: Params, manifest: Optional[dict] = None):
        self.wait()
        arrays = {_key(path): _host(leaf) for path, leaf in leaves_with_path(tree)}
        if not _writes():
            return

        def work():
            _write(self.ckpt_dir, step, arrays, manifest)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(list_steps(self.ckpt_dir))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def list_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                out.append(int(name.split("_")[1]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like: Params, shardings=None) -> Params:
    """The tree of `like`'s structure from checkpoint `step`, each leaf
    in the dtype and on the device of `like`'s leaf there. `shardings`
    (a tree of `distributed.sharding.NamedSharding`) places each leaf on
    its mesh as a DTensor instead."""
    data = np.load(os.path.join(ckpt_dir, f"step_{step:08d}", "state.npz"))
    places = dict(leaves_with_path(shardings)) if shardings is not None else {}
    flat = []
    for path, leaf in leaves_with_path(like):
        arr = torch.from_numpy(np.asarray(data[_key(path)])).to(dtype=leaf.dtype)
        flat.append(places[path].place(arr) if shardings is not None
                    else arr.to(device=leaf.device))
    return unflatten(like, flat)

