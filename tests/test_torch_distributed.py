"""The port's distributed layer on 4 CPU ranks (gloo) against the JAX
package's single-program results. One world of 4 processes
(tests/torch_dist_worker.py, torch and the port only) runs every
multi-rank check once; it joins through a file in this test's temp dir
(so parallel test workers never share a port), every collective times
out after 60 s, and the whole world must finish within DEADLINE_S or the
test fails with the ranks' logs.

Checked: the mesh train step of granite's fp32 smoke config (capacity
factor 1.0, so the global dispatch drops assignments at capacity) on a
(2, 2) mesh (MoE hints and sequence parallelism on) and on a (2, 1, 2)
multi-pod mesh with int8 gradient compression and 2 microbatches, 2
steps, against the
reference's `make_train_step` on the whole batch: losses, the first
batch's expert counts, every param and moment leaf (tolerances and the
compression FLIPS rule of tests/test_torch_training.py), with a grad
clip that binds; every rank's shard shapes equal to the specs'; the
(2, 2) checkpoint restored onto (4, 1) (in the worker) and on one
process (here, bitwise equal to the reference's restore);
`compressed_psum` and `cross_pod_grad_reduce` equal to sums of the
reference's per-rank int8 round trips; the grouped dispatch with the
hints on (1, 4) and (2, 2) equal to it without them (in the worker);
sequence-parallel GQA (6 heads over 4 ranks) and absorbed MLA equal to
the reference's unsharded attention (1e-5 abs; MLA 1e-4 rel, as
tests/test_seq_parallel.py)."""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_worker as worker
from repro.checkpoint import restore as jax_restore
from repro.checkpoint import save as jax_save
from repro.configs import get_config, reduce_for_smoke
from repro.data.pipeline import SyntheticCorpus as JaxCorpus
from repro.distributed.collectives import int8_dequantize, int8_quantize
from repro.models import attention as jatt
from repro.models.model import init_params as jax_init_params
from repro.training.optimizer import AdamWConfig as JaxAdamWConfig
from repro.training.optimizer import adamw_init as jax_adamw_init
from repro.training.optimizer import global_norm as jax_global_norm
from repro.training.train_step import loss_fn as jax_loss_fn
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.checkpoint import restore
from repro_torch.models.model import init_params
from repro_torch.training import AdamWConfig, adamw_init
from repro_torch.tree import leaves
from test_torch_training import ATOL, P_ATOL, P_RTOL, RTOL, _close_trees, _flip_bounds

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
DEADLINE_S = 120


def _jax_cfg(arch, **moe):
    cfg = reduce_for_smoke(get_config(arch))
    cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32",
                              moe_backend="ref")
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return cfg


def _inputs(io: Path) -> dict:
    """What the ranks read: granite's params, MLA's params and input, GQA's
    q / k / v (as the reference's seq-parallel test draws them) and each
    rank's tensor to reduce."""
    jcfg = _jax_cfg("granite-moe-1b-a400m", capacity_factor=worker.CAPACITY_FACTOR)
    params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    jax_save(str(io / "params"), 0, params)
    dcfg = _jax_cfg("deepseek-v2-236b")
    mla = {"p": jax.tree.map(np.asarray, jatt.init_mla(jax.random.PRNGKey(0), dcfg)),
           "x": np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 32, dcfg.d_model)))}
    jax_save(str(io / "mla"), 0, mla)
    rng = np.random.default_rng(0)
    arrays = {n: rng.standard_normal(shape).astype(np.float32)
              for n, shape in (("q", (2, 32, 6, 16)), ("k", (2, 32, 2, 16)),
                               ("v", (2, 32, 2, 16)), ("psum_x", (WORLD, 33, 17)))}
    arrays["mla_x_shape"] = np.array(mla["x"].shape)
    np.savez(io / "arrays.npz", **arrays)
    return dict(jcfg=jcfg, dcfg=dcfg, params=params, mla=mla, **arrays)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    io = tmp_path_factory.mktemp("dist")
    inputs = _inputs(io)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    logs = [open(io / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
                               str(r), str(WORLD), str(io / "init"), str(io)],
                              env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    end = time.time() + DEADLINE_S
    while any(p.poll() is None for p in procs) and time.time() < end:
        if any(p.poll() not in (None, 0) for p in procs):
            break  # one rank failed: the others would wait for it
        time.sleep(0.2)
    failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
    running = [r for r, p in enumerate(procs) if p.poll() is None]
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    for f in logs:
        f.close()
    text = "\n".join(f"--- rank {r}\n" + (io / f"rank{r}.log").read_text()[-3000:]
                     for r in range(WORLD))
    why = (f"ranks {failed} failed (ranks {running} stopped)" if failed
           else f"ranks {running} still running after {DEADLINE_S} s")
    assert not failed and not running, why + "\n" + text
    out = json.loads((io / "out.json").read_text())
    return io, inputs, out, dict(np.load(io / "out_arrays.npz"))


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


_first_grads = jax.jit(jax.value_and_grad(jax_loss_fn, has_aux=True), static_argnums=1)


def _capacity(n, k, e, cf):
    return min(n, max(k, int(n * k * cf / e + 0.5)))


@pytest.mark.parametrize("case", list(worker.TRAIN_CASES))
def test_mesh_train_step_matches_reference(world, case):
    io, inputs, out, _ = world
    _, _, compression, _, n_micro = worker.TRAIN_CASES[case]
    jcfg, params = inputs["jcfg"], inputs["params"]
    opt_cfg = JaxAdamWConfig(compression=compression, grad_clip=worker.GRAD_CLIP)
    corpus = JaxCorpus(jcfg.vocab_size, seed=0)
    # the first batch on the whole program: loss and counts; the capacity
    # drops assignments and the clip binds, so both must be global
    (loss0, m0), grads0 = _first_grads(_jnp(params), jcfg,
                                       _jnp(corpus.batch(0, worker.B, worker.S)))
    counts = np.asarray(m0["expert_counts"])
    cap = _capacity(worker.B * worker.S, jcfg.moe.top_k, jcfg.moe.n_experts,
                    worker.CAPACITY_FACTOR)
    assert np.maximum(counts - cap, 0).sum() > 0, "the config must drop assignments"
    assert float(jax_global_norm(grads0)) > worker.GRAD_CLIP, "the clip must bind"
    np.testing.assert_array_equal(np.asarray(out[f"{case}/counts0"]), counts)
    np.testing.assert_allclose(out[f"{case}/loss0"], float(loss0), atol=ATOL, rtol=RTOL)

    step = jax.jit(jax_make_train_step(jcfg, opt_cfg, n_microbatches=n_micro))
    jp, jo = _jnp(params), jax_adamw_init(_jnp(params), opt_cfg)
    for i in range(worker.STEPS):
        jp, jo, m = step(jp, jo, _jnp(corpus.batch(i, worker.B, worker.S)))
        np.testing.assert_allclose(out[f"{case}/losses"][i], float(m["loss"]), atol=ATOL,
                                   rtol=RTOL)
    like_p = init_params(0, worker.granite_cfg(), device="cpu")
    like = {"params": like_p, "opt": adamw_init(like_p, AdamWConfig(compression=compression))}
    got = restore(str(io / f"state_{case}"), worker.STEPS, like)
    _close_trees(got["params"], jp, P_ATOL, P_RTOL, "param")
    bounds = _flip_bounds(jo["v"], compression) if compression != "none" else {}
    for part in ("m", "v") + (("ef",) if compression == "int8_ef" else ()):
        _close_trees(got["opt"][part], jo[part], ATOL, RTOL, part, flips=bounds.get(part))
    assert int(got["opt"]["step"]) == int(jo["step"]) == worker.STEPS


def test_shard_shapes_and_checkpoint_reshard(world):
    io, _, out, _ = world
    like_p = init_params(0, worker.granite_cfg(), device="cpu")
    n_leaves = len(leaves(like_p))
    assert out["shard_shapes"] == len(worker.TRAIN_CASES) * n_leaves
    # (4, 1): every leaf of params + m, v, step restored on each rank
    assert out["resharded_leaves"] == 3 * n_leaves + 1
    # one process, without a mesh: bitwise the reference's own restore
    like = {"params": like_p, "opt": adamw_init(like_p)}
    got = restore(str(io / "state_2x2"), worker.STEPS, like)
    want = jax_restore(str(io / "state_2x2"), worker.STEPS,
                       jax.tree.map(lambda t: np.zeros(t.shape, np.float32), got))
    _close_trees(got, want, 0, 0, "restored")


def _roundtrip(x):
    q, s = int8_quantize(jnp.asarray(x))
    return np.asarray(int8_dequantize(q, s))


def _sum_bound(terms, ulps):
    return ulps * np.finfo(np.float32).eps * np.sum(np.abs(terms), axis=0)


def test_compressed_psum_and_cross_pod_reduce(world):
    _, inputs, _, arrays = world
    xs = inputs["psum_x"]
    rt = np.stack([_roundtrip(x) for x in xs])
    for r in range(WORLD):
        err = np.abs(arrays["psum_int8"][r] - rt.sum(0))
        assert np.all(err <= _sum_bound(rt, WORLD)), "int8"
        err = np.abs(arrays["psum_none"][r] - xs.sum(0))
        assert np.all(err <= _sum_bound(xs, WORLD)), "none"
        # bf16: each rank's cast, then a bf16 sum over the ranks
        b16 = np.asarray(jnp.asarray(xs).astype(jnp.bfloat16).astype(jnp.float32))
        err = np.abs(arrays["psum_bf16"][r] - b16.sum(0))
        assert np.all(err <= WORLD * 2.0 ** -8 * np.abs(b16).sum(0)), "bf16"
        # (2, 1, 2): the mean over the 2 pods of this rank's model column
        col = [xs[p * 2 + r % 2] / 2 for p in range(2)]
        want = sum(_roundtrip(c) for c in col)
        err = np.abs(arrays["pod_reduce"][r] - want)
        assert np.all(err <= _sum_bound(np.stack([_roundtrip(c) for c in col]), 2)), "pod"


def test_grouped_dispatch_with_hints_equals_without(world):
    _, _, out, _ = world
    for shape in ("1x4", "2x2"):
        assert out[f"grouped_hints/{shape}/max_err"] < 1e-5


def test_sequence_parallel_attention_matches_reference(world):
    _, inputs, _, arrays = world
    q, k, v = (jnp.asarray(inputs[n]) for n in ("q", "k", "v"))
    base = np.asarray(jatt._grouped_attention(q, k, v, causal=True, q_chunk=8))
    assert np.max(np.abs(arrays["seq_gqa"] - base)) < 1e-5
    mla = inputs["mla"]
    ref, _ = jatt.mla_forward(_jnp(mla["p"]), inputs["dcfg"], jnp.asarray(mla["x"]),
                              jnp.arange(32)[None, :])
    ref = np.asarray(ref)
    rel = np.max(np.abs(arrays["seq_mla"] - ref)) / np.max(np.abs(ref))
    assert rel < 1e-4, rel
