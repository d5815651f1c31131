"""The port's sharding rules (repro_torch/distributed/sharding.py) held
equal to the reference's entry by entry: every param leaf of every
ASSIGNED arch at full size (the reference's `jax.eval_shape` tree beside
the port's meta-device init), FSDP on and off, on the single-pod
(16 x 16) and multi-pod (2 x 16 x 16) mesh shapes; the decode and
long-context cache trees, every MoE arch's tiered tree, the optimizer
specs and the replicated-leaf report; the spec -> DTensor placements
mapping; and the int8 wire format bitwise against the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed
from torch.distributed.tensor import Replicate, Shard

import repro.distributed.sharding as jsh
import repro_torch.configs as tcfgs
from repro.configs import ASSIGNED, get_config
from repro.distributed.collectives import int8_dequantize as jax_dequantize
from repro.distributed.collectives import int8_quantize as jax_quantize
from repro.models.model import init_cache as jax_init_cache
from repro.models.model import init_params as jax_init_params
from repro.serving.engine import init_tiered_for_model as jax_init_tiered
from repro.serving.tiered_moe import tier_sizes as jax_tier_sizes
from repro.training.optimizer import adamw_init as jax_adamw_init
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.collectives import int8_dequantize, int8_quantize
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models.layers import make_generator
from repro_torch.models.model import init_params
from repro_torch.serving.engine import init_tiered_for_model
from repro_torch.serving.kv_cache import cache_spec
from repro_torch.serving.tiered_moe import tier_sizes
from repro_torch.training.optimizer import adamw_init
from repro_torch.tree import leaves_with_path


class FakeMesh:
    """Duck-typed mesh: the rules read only .shape."""

    def __init__(self, shape):
        self.shape = shape


MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}
MOE_ARCHS = [a for a in ASSIGNED if get_config(a).moe is not None]
DECODE = {"decode_32k": (128, 32768), "long_500k": (1, 524288)}


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp): leaf
            for kp, leaf in flat}


def _jax_specs(specs):
    return jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _port_leaves(tree):
    return {tsh.path_str(p): leaf for p, leaf in leaves_with_path(tree)}


def _assert_specs_equal(jax_tree, jax_spec_tree, port_tree, port_spec_tree):
    """The two spec trees equal leaf by leaf, over the same paths and shapes."""
    jl, pl = _jax_leaves(jax_tree), _port_leaves(port_tree)
    assert sorted(jl) == sorted(pl)
    js = dict(zip(_jax_leaves(jax_tree), _jax_specs(jax_spec_tree)))
    ps = {tsh.path_str(p): s for p, s in tsh.spec_leaves(port_spec_tree).items()}
    for path in jl:
        assert tuple(jl[path].shape) == tuple(pl[path].shape), path
        assert tuple(js[path]) == ps[path], (path, js[path], ps[path])
    return len(jl)


_PARAMS = {}


def _params(arch):
    if arch not in _PARAMS:
        cfg = get_config(arch)
        _PARAMS[arch] = (jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), cfg)),
                         init_params(0, tcfgs.get_config(arch), device="meta"))
    return _PARAMS[arch]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_specs_equal_reference(arch, mesh):
    jp, tp = _params(arch)
    shape = MESHES[mesh]
    cfg, tcfg = get_config(arch), tcfgs.get_config(arch)
    for fsdp in (False, True):
        n = _assert_specs_equal(jp, jsh.tree_pspecs(jp, FakeMesh(shape), fsdp=fsdp),
                                tp, tsh.tree_pspecs(tp, shape, fsdp=fsdp))
        assert n > 5
    # the arch's own FSDP choice (param count over the threshold)
    _assert_specs_equal(jp, jsh.tree_pspecs(jp, FakeMesh(shape), cfg),
                        tp, tsh.tree_pspecs(tp, shape, tcfg))
    # a DeviceMesh-like object (.shape a tuple beside mesh_dim_names) reads the same
    dm = type("DM", (), {"mesh_dim_names": tuple(shape), "shape": tuple(shape.values())})()
    assert tsh.tree_pspecs(tp, dm, tcfg) == tsh.tree_pspecs(tp, shape, tcfg)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_and_tiered_specs_equal_reference(mesh):
    shape = MESHES[mesh]
    for arch in ASSIGNED:
        cfg, tcfg = get_config(arch), tcfgs.get_config(arch)
        for name, (b, s) in DECODE.items():
            jc = jax.eval_shape(lambda: jax_init_cache(cfg, b, s))
            tc = cache_spec(tcfg, b, s)
            _assert_specs_equal(jc, jsh.cache_pspecs(jc, FakeMesh(shape)),
                                tc, tsh.cache_pspecs(tc, shape))
    for arch in MOE_ARCHS:
        cfg, tcfg = get_config(arch), tcfgs.get_config(arch)
        assert tuple(tier_sizes(tcfg)) == tuple(jax_tier_sizes(cfg))
        jt = jax.eval_shape(lambda: jax_init_tiered(jax.random.PRNGKey(1), cfg,
                                                    jax_tier_sizes(cfg)))
        tt = init_tiered_for_model(make_generator(1, "meta"), tcfg, tier_sizes(tcfg))
        _assert_specs_equal(jt, jsh.tiered_pspecs(jt, FakeMesh(shape)),
                            tt, tsh.tiered_pspecs(tt, shape))


def _report(rows):
    """The reference's report with its paths as "a/b/c" (it joins JAX's
    key reprs: "['a']/['b']")."""
    return [(path.replace("['", "").replace("']", ""), tuple(shape)) for path, shape in rows]


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "llama3.2-3b"])
def test_opt_state_specs_and_replicated_report_equal_reference(arch):
    jp, tp = _params(arch)
    cfg, tcfg = get_config(arch), tcfgs.get_config(arch)
    for shape in MESHES.values():
        jspecs = jsh.tree_pspecs(jp, FakeMesh(shape), cfg)
        tspecs = tsh.tree_pspecs(tp, shape, tcfg)
        jo = jax.eval_shape(lambda: jax_adamw_init(jp))
        to = adamw_init(tp)
        jos, tos = jsh.opt_state_pspecs(jo, jspecs), tsh.opt_state_pspecs(to, tspecs)
        assert sorted(jos) == sorted(tos) == ["m", "step", "v"]
        assert tuple(jos["step"]) == tos["step"] == ()
        for k in ("m", "v"):
            _assert_specs_equal(jo[k], jos[k], to[k], tos[k])
        for min_bytes in (1 << 24, 1 << 16):
            want = _report(jsh.report_replicated(jp, FakeMesh(shape), cfg, min_bytes))
            got = tsh.report_replicated(tp, shape, tcfg, min_bytes)
            assert got == want
    # a mesh too small to shard some leaves reports them as the reference does
    small = {"data": 2, "model": 3}
    want = _report(jsh.report_replicated(jp, FakeMesh(small), cfg, 1 << 10))
    assert tsh.report_replicated(tp, small, tcfg, 1 << 10) == want and want


def test_batch_and_dp_specs_equal_reference():
    for shape in MESHES.values():
        assert jsh.dp_axes(FakeMesh(shape)) == tsh.dp_axes(shape)
        for nd in (1, 2, 3):
            assert tuple(jsh.batch_pspec(FakeMesh(shape), nd)) == tsh.batch_pspec(shape, nd)
    assert tsh.dp_axes({"model": 4}) is None and tsh.dp_size({"model": 4}) == 1


def test_spec_placements_and_shard_shapes():
    mesh = {"pod": 2, "data": 4, "model": 2}
    assert tsh.placements((None, "model"), mesh) == [Replicate(), Replicate(), Shard(1)]
    assert tsh.placements((("data", "model"), None), mesh) == [Replicate(), Shard(0), Shard(0)]
    assert tsh.placements((("pod", "data"), "model"), mesh) == [Shard(0), Shard(0), Shard(1)]
    assert tsh.placements((), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError):  # names out of mesh order
        tsh.placements((("model", "data"),), mesh)
    assert tsh.shard_shape((64, 6, 10), (("data", "model"), None, "pod"), mesh) == (8, 6, 5)
    with pytest.raises(ValueError):  # an uneven shard
        tsh.shard_shape((6,), ("data",), mesh)
    assert tsh.replicas_of(tsh.placements((None, "model"), mesh), mesh) == 8


def test_mesh_without_process_group_raises():
    """No silent fallback to one process: a mesh needs a process group."""
    assert not torch.distributed.is_initialized()
    for make in (lambda: make_debug_mesh(device_type="cpu"),
                 lambda: make_production_mesh(device_type="cpu"),
                 lambda: make_production_mesh(multi_pod=True, device_type="cpu")):
        with pytest.raises(RuntimeError, match="no process group"):
            make()


def test_int8_round_trip_bitwise_equal_reference():
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(64, 33)).astype(np.float32),
          (rng.normal(size=257) * 1e-3).astype(np.float32),
          # exact midpoints of the grid: round half to even on both sides
          np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0, -127.0, 3.5], np.float32),
          np.zeros(5, np.float32)]
    for x in xs:
        qj, sj = jax_quantize(jnp.asarray(x))
        qt, st = int8_quantize(torch.from_numpy(x))
        assert qt.dtype == torch.int8
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert st.numpy().tobytes() == np.asarray(sj).tobytes()
        dj = np.asarray(jax_dequantize(qj, sj))
        np.testing.assert_array_equal(int8_dequantize(qt, st).numpy(), dj)
