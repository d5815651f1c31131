"""The port's distributed layer on 4 CPU ranks (gloo) against the JAX
package's single-program results. One world of 4 processes
(tests/torch_dist_worker.py, torch and the port only) runs every
multi-rank check once, and a world of one rank beside it the (1, 1)
check; each joins through a file in this test's temp dir (so parallel
test workers never share a port), every collective times out after 60 s,
and both must finish within DEADLINE_S or the test fails with the ranks'
logs. The reference's train steps run here while the worlds run.

Checked: the mesh train step, partitioned as GSPMD partitions the
reference's program (heads, channels, F and the vocab over "model", rows
over the DP axes, FSDP weights gathered over "data"), for every assigned
arch group at fp32 smoke configs (the worker's TRAIN_CASES): granite's
(capacity factor 1.0, so the global dispatch drops assignments at
capacity) on (2, 2) with the MoE hints and sequence parallelism on and
on the (2, 1, 2) multi-pod mesh with int8 gradient compression and 2
microbatches; llama3.2-3b (tied vocab-parallel head, the MLP stack split
over its layers), granite-20b (MQA, FSDP with wk nested over data x
model), phi4-mini on (1, 4) (6 heads that do not divide: D-split
projections, query rows over "model"; a vocab of 258: the D-split head),
deepseek (MLA, shared experts), jamba (Mamba channel-parallel), xlstm
(mLSTM over heads; with 2 heads on (1, 4) along the key index) and
seamless (the encoder, cacheless cross attention) on (2, 2), and granite
with 6 experts on (1, 4) (the routed experts split over F); 2 steps
each, against the reference's `make_train_step` on the whole batch:
losses, the first batch's expert counts, every param and moment leaf
(tolerances and the compression FLIPS rule of
tests/test_torch_training.py), with a grad clip that binds; no
all-gather of granite's (2, 2) step has the bytes of a whole leaf that
the rules split over "model"; every rank's shard shapes equal to the
specs'; the (2, 2) checkpoint restored onto (4, 1) (in the worker) and
on one process (here, bitwise equal to the reference's restore); on one
rank, the (1, 1) mesh step bitwise equal to the unsharded step (granite,
jamba); `compressed_psum` and `cross_pod_grad_reduce` equal to sums of
the reference's per-rank int8 round trips; the grouped dispatch with the
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
from repro.distributed.collectives import int8_dequantize, int8_quantize
from repro.models import attention as jatt
from repro.models.model import forward_train as jax_forward_train
from repro.training.optimizer import AdamWConfig as JaxAdamWConfig
from repro.training.optimizer import adamw_init as jax_adamw_init
from repro.training.optimizer import global_norm as jax_global_norm
from repro.training.train_step import loss_fn as jax_loss_fn
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.checkpoint import restore
from repro_torch.models.model import init_params
from repro_torch.training import AdamWConfig, adamw_init
from repro_torch.tree import leaves, leaves_with_path, tree_map
from test_torch_training import ATOL, P_ATOL, P_RTOL, RTOL, _close_trees, _flip_bounds

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import keep_groups  # noqa: E402

WORLD = 4
# a hang guard: on an idle 8-core host the 4-rank world takes ~22 s and the
# one-rank world ~6 s, beside the reference's steps here (~47 s)
DEADLINE_S = 240


def _jax_cfg(arch, config=(), **moe):
    cfg = reduce_for_smoke(get_config(arch))
    if arch in worker.DENSE:
        cfg = keep_groups(cfg, get_config(arch))
    cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32",
                              moe_backend="ref", **dict(config))
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return cfg


def case_cfg(case):
    """The reference's config of a worker TrainCase (`worker.case_cfg`'s)."""
    moe = {"capacity_factor": worker.CAPACITY_FACTOR} if case.arch == worker.GRANITE else {}
    return _jax_cfg(case.arch, case.config, **moe, **dict(case.moe))


def _inputs(io: Path) -> dict:
    """What the ranks read: MLA's params and input, GQA's q / k / v (as the
    reference's seq-parallel test draws them) and each rank's tensor to
    reduce; and each train case's reference config with the params the
    ranks start from (the port's seeded init, `worker.case_params`)."""
    cases = {}
    for name, case in worker.TRAIN_CASES.items():
        params = worker.case_params(worker.case_cfg(case))
        cases[name] = (case_cfg(case), tree_map(lambda t: t.numpy(), params))
    jcfg, params = cases["2x2"]
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
    return dict(jcfg=jcfg, dcfg=dcfg, params=params, mla=mla, cases=cases, **arrays)


def _spawn(io: Path, world: int):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    io.mkdir(exist_ok=True)
    logs = [open(io / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
                               str(r), str(world), str(io / "init"), str(io)],
                              env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    return io, procs, logs


def _wait(io: Path, procs, logs, end: float) -> dict:
    """Rank 0's results once every rank exits 0, or an AssertionError with
    the ranks' logs if one failed or is still running at `end` (then
    killed)."""
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
                     for r in range(len(procs)))
    why = (f"ranks {failed} failed (ranks {running} stopped)" if failed
           else f"ranks {running} still running after {DEADLINE_S} s")
    assert not failed and not running, why + "\n" + text
    return json.loads((io / "out.json").read_text())


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


_first_grads = jax.jit(jax.value_and_grad(jax_loss_fn, has_aux=True), static_argnums=1)
_forward = jax.jit(jax_forward_train, static_argnums=1)


def _capacity(n, k, e, cf):
    return min(n, max(k, int(n * k * cf / e + 0.5)))


def reference(name, jcfg, params) -> dict:
    """The reference's first-batch counts (and loss and gradient norm
    where the case's step runs microbatches, and for granite's (2, 2)) and
    STEPS steps of `make_train_step` on the whole batch: losses, params,
    opt state."""
    case = worker.TRAIN_CASES[name]
    out = {}
    cfg = worker.case_cfg(case)
    batch0 = _jnp(worker.case_batch(cfg, 0))
    if name == "2x2" or case.n_micro > 1:
        (loss0, m0), grads0 = _first_grads(_jnp(params), jcfg, batch0)
        out.update(loss0=float(loss0), counts0=np.asarray(m0["expert_counts"]),
                   norm0=float(jax_global_norm(grads0)))
    elif jcfg.moe is not None:
        out["counts0"] = np.asarray(_forward(_jnp(params), jcfg, batch0)[2])
    opt_cfg = JaxAdamWConfig(compression=case.compression, grad_clip=worker.GRAD_CLIP)
    step = jax.jit(jax_make_train_step(jcfg, opt_cfg, n_microbatches=case.n_micro))
    jp, jo = _jnp(params), jax_adamw_init(_jnp(params), opt_cfg)
    losses = []
    for i in range(worker.STEPS):
        jp, jo, m = step(jp, jo, _jnp(worker.case_batch(cfg, i)))
        losses.append(float(m["loss"]))
    out.update(losses=losses, params=jp, opt=jo)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    io = tmp_path_factory.mktemp("dist")
    inputs = _inputs(io)
    end = time.time() + DEADLINE_S
    four = _spawn(io, WORLD)
    one = _spawn(io / "one", 1)
    refs = {name: reference(name, *inputs["cases"][name]) for name in worker.TRAIN_CASES}
    out = _wait(*four, end)
    out["one_rank"] = _wait(*one, end)
    return io, inputs, out, dict(np.load(io / "out_arrays.npz")), refs


def _case_cfg_torch(name):
    return worker.case_cfg(worker.TRAIN_CASES[name])


@pytest.mark.parametrize("case", list(worker.TRAIN_CASES))
def test_mesh_train_step_matches_reference(world, case):
    io, inputs, out, _, refs = world
    ref = refs[case]
    jcfg = inputs["cases"][case][0]
    compression = worker.TRAIN_CASES[case].compression
    counts = out[f"{case}/counts0"]
    if case == "2x2":
        # the capacity drops assignments and the clip binds, so both must
        # be global
        cap = _capacity(worker.B * worker.S, jcfg.moe.top_k, jcfg.moe.n_experts,
                        worker.CAPACITY_FACTOR)
        assert np.maximum(ref["counts0"] - cap, 0).sum() > 0, "the config must drop"
        assert ref["norm0"] > worker.GRAD_CLIP, "the clip must bind"
    if "counts0" in ref:
        np.testing.assert_array_equal(np.asarray(counts), ref["counts0"])
    else:  # no routed experts: a zero row per scanned layer, as the reference's
        assert np.asarray(counts).ndim == 2 and not np.asarray(counts).any()
    # the whole first batch's loss (a step over microbatches averages theirs)
    loss0 = ref["loss0"] if "loss0" in ref else ref["losses"][0]
    np.testing.assert_allclose(out[f"{case}/loss0"], loss0, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out[f"{case}/losses"], ref["losses"], atol=ATOL, rtol=RTOL)
    like_p = init_params(0, _case_cfg_torch(case), device="cpu")
    like = {"params": like_p, "opt": adamw_init(like_p, AdamWConfig(compression=compression))}
    got = restore(str(worker.state_dir(io, case)), worker.STEPS, like)
    jp, jo = ref["params"], ref["opt"]
    _close_trees(got["params"], jp, P_ATOL, P_RTOL, "param")
    bounds = _flip_bounds(jo["v"], compression) if compression != "none" else {}
    for part in ("m", "v") + (("ef",) if compression == "int8_ef" else ()):
        _close_trees(got["opt"][part], jo[part], ATOL, RTOL, part, flips=bounds.get(part))
    assert int(got["opt"]["step"]) == int(jo["step"]) == worker.STEPS


def test_mesh_train_step_gathers_no_model_split_leaf_whole(world):
    """No all-gather of granite's (2, 2) step (the recorded first step)
    returns the bytes of a whole leaf (one scan group of a stacked one)
    that the rules split over "model": the step computes on its shards."""
    from repro_torch.distributed import sharding as shd

    _, _, out, _, _ = world
    cfg = _case_cfg_torch("2x2")
    params = init_params(0, cfg, device="meta")
    specs = shd.spec_leaves(shd.tree_pspecs(params, {"data": 2, "model": 2}, cfg))
    whole = set()
    for path, leaf in leaves_with_path(params):
        if any(e == "model" or (isinstance(e, tuple) and "model" in e) for e in specs[path]):
            shape = leaf.shape[1:] if path[0] == "stack" else leaf.shape
            whole.add(int(np.prod(shape)) * leaf.element_size())
    gathers = out["2x2/gathers"]
    assert gathers, "the step gathers (the expert counts over the DP shards)"
    assert not whole & set(gathers), sorted(whole & set(gathers))


def test_one_rank_mesh_step_bitwise_equals_unsharded(world):
    _, _, out, _, _ = world
    for arch in (worker.GRANITE, "jamba-v0.1-52b"):
        assert out["one_rank"][f"one_rank/{arch}"] > 0, arch


def test_shard_shapes_and_checkpoint_reshard(world):
    io, _, out, _, _ = world
    n_leaves = {name: len(leaves(init_params(0, _case_cfg_torch(name), device="meta")))
                for name in worker.TRAIN_CASES}
    assert out["shard_shapes"] == sum(n_leaves.values())
    like_p = init_params(0, worker.granite_cfg(), device="cpu")
    n_leaves = len(leaves(like_p))
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
    _, inputs, _, arrays, _ = world
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
    _, _, out, _, _ = world
    for shape in ("1x4", "2x2"):
        assert out[f"grouped_hints/{shape}/max_err"] < 1e-5


def test_sequence_parallel_attention_matches_reference(world):
    _, inputs, _, arrays, _ = world
    q, k, v = (jnp.asarray(inputs[n]) for n in ("q", "k", "v"))
    base = np.asarray(jatt._grouped_attention(q, k, v, causal=True, q_chunk=8))
    assert np.max(np.abs(arrays["seq_gqa"] - base)) < 1e-5
    mla = inputs["mla"]
    ref, _ = jatt.mla_forward(_jnp(mla["p"]), inputs["dcfg"], jnp.asarray(mla["x"]),
                              jnp.arange(32)[None, :])
    ref = np.asarray(ref)
    rel = np.max(np.abs(arrays["seq_mla"] - ref)) / np.max(np.abs(ref))
    assert rel < 1e-4, rel
