"""The port's checkpoint format is the JAX package's: a checkpoint of a
train state ({"params", "opt"}: bf16 params, fp32 moments, an int32
step) saved by either package restores in the other to the bridged tree,
bitwise, in the leaf dtypes of the tree it is restored into. The port's
train driver resumes from its latest checkpoint."""
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jax_restore
from repro.checkpoint import save as jax_save
from repro.configs import get_config, reduce_for_smoke
from repro.models.model import init_params as jax_init_params
from repro.training.optimizer import adamw_init as jax_adamw_init
from repro_torch.bridge import to_torch
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, list_steps, restore, save
from repro_torch.launch import train as train_driver
from repro_torch.tree import leaves_with_path, tree_map

ARCH = "granite-moe-1b-a400m"


@pytest.fixture(scope="module")
def jax_state():
    """A JAX train state of the bf16 smoke config, moments made nonzero."""
    params = jax_init_params(jax.random.PRNGKey(0), reduce_for_smoke(get_config(ARCH)))
    opt = jax_adamw_init(params)
    opt = {**opt, "m": jax.tree.map(lambda p: p.astype(jnp.float32) * 0.5, params),
           "step": jnp.int32(7)}
    return {"params": params, "opt": opt}


def _equal(got, want_host):
    """`got` (port tree) equals the host tree `want_host` bitwise, leaf by
    leaf, with the bridged dtypes."""
    want = to_torch(want_host)
    for (path, g), (wpath, w) in zip(leaves_with_path(got), leaves_with_path(want)):
        assert path == wpath
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g, w), path


def test_jax_checkpoint_restores_in_the_port(tmp_path, jax_state):
    jax_save(str(tmp_path), 5, jax_state)
    host = jax.tree.map(np.asarray, jax_state)
    like = tree_map(torch.zeros_like, to_torch(host))
    assert latest_step(str(tmp_path)) == 5
    got = restore(str(tmp_path), 5, like)
    _equal(got, host)
    assert got["params"]["embed"]["table"].dtype == torch.bfloat16


def test_port_checkpoint_restores_in_jax(tmp_path, jax_state):
    host = jax.tree.map(np.asarray, jax_state)
    save(str(tmp_path), 9, to_torch(host), manifest={"arch": ARCH})
    like = jax.tree.map(jnp.zeros_like, jax_state)
    got = jax_restore(str(tmp_path), 9, like)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(jax_state)
    for (kp, g), (_, w) in zip(flat_got, flat_want):
        assert g.dtype == w.dtype, kp
        np.testing.assert_array_equal(np.asarray(g.astype(jnp.float32)),
                                      np.asarray(w.astype(jnp.float32)))


def test_async_checkpointer_keeps_the_last_and_commits_atomically(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3, dtype=torch.bfloat16),
            "step": torch.tensor(3, dtype=torch.int32)}
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save_async(s, tree)
    ck.wait()
    assert list_steps(str(tmp_path)) == [3, 4]
    assert not any(n.startswith("tmp") for n in os.listdir(tmp_path))
    got = restore(str(tmp_path), 4, tree_map(torch.zeros_like, tree))
    for k in tree:
        assert got[k].dtype == tree[k].dtype and torch.equal(got[k], tree[k])


def test_train_driver_auto_resumes(tmp_path, capsys):
    """Two runs of the driver on the CPU: the second resumes from the
    first's latest checkpoint and runs only the remaining steps."""
    old = signal.getsignal(signal.SIGTERM)  # the driver installs a preemption handler
    try:
        args = ["--arch", ARCH, "--smoke", "--batch", "2", "--seq", "16", "--device", "cpu",
                "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--log-every", "100"]
        first = train_driver.main(args + ["--steps", "5"])
        assert latest_step(str(tmp_path)) == 4
        # the checkpoint of step index 4 holds the state after 5 updates (a
        # resume re-runs the batch of its step, as the reference's driver does)
        like = {"opt": {"step": torch.zeros((), dtype=torch.int32)}}
        assert int(restore(str(tmp_path), 4, like)["opt"]["step"]) == 5
        second = train_driver.main(args + ["--steps", "6"])
    finally:
        signal.signal(signal.SIGTERM, old)
    assert len(first) == 5 and len(second) == 2
    assert "auto-resume from step 4" in capsys.readouterr().out
    assert all(np.isfinite(first + second))
