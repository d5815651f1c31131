"""Weight bridge: the JAX package's params and tiered-state pytrees, as
nested dicts of numpy arrays, into the port's tensors with the same tree
paths (`stack/slot0/...`, scan-group dim first).

numpy has no bfloat16: a JAX bf16 leaf arrives as an `ml_dtypes`
bfloat16 array, which `torch.from_numpy` rejects. Such leaves go through
float32 (exact) and are then cast to torch.bfloat16. Bridging the tiered
state as well as the params carries the random padding slots of the
cold buffer across, which migrations may move, so the port's plans and
tokens can equal the reference's.
"""
from __future__ import annotations

import numpy as np
import torch


def to_torch(tree, device="cpu"):
    """Nested dict of arrays (anything `np.asarray` accepts) -> the same
    nested dict of torch tensors on `device`, dtypes preserved."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    # a copy: the port updates pools and tier buffers in place, and JAX's
    # host arrays are read-only
    return torch.tensor(a, device=device)
