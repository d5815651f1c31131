"""Device meshes (port of repro/launch/mesh.py).

Single pod: 16 x 16 = 256 devices, dims ("data", "model"). Multi-pod:
2 x 16 x 16 = 512, dims ("pod", "data", "model"); the pod dim carries
only data parallelism (and the compressed gradient reduce,
distributed/collectives.py).

Functions, not module constants: importing this module touches no
device and no process group. A mesh spans the initialised process group
(`torch.distributed.init_process_group`, e.g. under `torchrun`) and is
built on CUDA devices unless the caller asks for "cpu" (gloo). Asking
for a mesh with no process group raises: nothing falls back to one
process.
"""
from __future__ import annotations

import torch.distributed as dist


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: initialise torch.distributed "
                           "(e.g. run under torchrun) before asking for a mesh")
    return dist.get_world_size()


def make_mesh(shape, names, device_type: str = "cuda"):
    """A DeviceMesh of `shape` with dims `names` over the whole world."""
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    if n != _world_size():
        raise ValueError(f"a {tuple(shape)} mesh needs {n} processes, the world has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, names, device_type)


def make_debug_mesh(n_devices: int | None = None, device_type: str = "cuda"):
    """A small ("data", "model") mesh over the world (tests, examples):
    (n // model, model), model the largest of 4, 2, 1 that divides n."""
    n = n_devices or _world_size()
    model = next(m for m in (4, 2, 1) if n % m == 0)
    return make_mesh((n // model, model), ("data", "model"), device_type)
