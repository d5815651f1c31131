"""One rank of the 4-process gloo world that tests/test_torch_distributed.py
spawns (imports torch and the port only):

  python tests/torch_dist_worker.py RANK WORLD INIT_FILE IO_DIR

Reads its inputs from IO_DIR (written by the test), holds what compares
the port with itself (local shard shapes, the hinted grouped dispatch vs
the unhinted one with its gradients, a checkpoint restored onto another
mesh), and has rank 0 write what the test compares with the JAX package
(train states of every TRAIN_CASES arch, sequence-parallel attention,
compressed reduces). With WORLD 1 it runs the one-rank (1, 1) check
instead (`one_rank`: the mesh step bitwise equal to the unsharded one).
Any failed check raises, so the rank exits non-zero."""
import dataclasses
import datetime
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import keep_groups  # noqa: E402
from repro_torch.checkpoint import restore, save  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.data.pipeline import SyntheticCorpus  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.collectives import (  # noqa: E402
    all_reduce,
    compressed_psum,
    cross_pod_grad_reduce,
)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.models.layers import make_generator  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.models.moe import init_moe, moe_forward, set_moe_sharding_hints  # noqa: E402
from repro_torch.training import (  # noqa: E402
    AdamWConfig,
    adamw_init,
    make_train_step,
    mesh_value_and_grad,
    shard_train_state,
)
from repro_torch.tree import leaves_with_path, tree_map  # noqa: E402

B, S, STEPS = 4, 32, 2
CAPACITY_FACTOR = 1.0  # granite's smoke batch then drops assignments at capacity
GRAD_CLIP = 0.1  # below the first step's gradient norm: the clip binds
GRANITE = "granite-moe-1b-a400m"
DENSE = ("llama3.2-3b", "phi4-mini-3.8b", "qwen2.5-32b", "chameleon-34b", "granite-20b")
MESHES = {"2x2": ((2, 2), ("data", "model")), "1x4": ((1, 4), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class TrainCase:
    arch: str
    mesh: str = "2x2"
    compression: str = "none"
    hints: bool = False  # the MoE hints and sequence parallelism on
    n_micro: int = 1
    fsdp: bool = False  # params also split over "data"
    config: tuple = ()  # (field, value) pairs over the smoke config
    moe: tuple = ()  # (field, value) pairs over its MoE config


# every assigned arch group, 2 steps each against the reference's
# make_train_step on the whole batch (the test)
TRAIN_CASES = {
    # GQA, the flat MoE expert-parallel under the hints; capacity drops
    "2x2": TrainCase(GRANITE, hints=True),
    # int8 compression with error feedback, 2 microbatches, across pods
    "2x1x2": TrainCase(GRANITE, "2x1x2", "int8_ef", n_micro=2),
    # tied table (vocab-parallel head), the MLP stack split over its layers
    "llama3.2-3b": TrainCase("llama3.2-3b"),
    # MQA (KV D-split, 48 query heads split), FSDP: wk nested over
    # ("data", "model"), every weight gathered over "data"
    "granite-20b/fsdp": TrainCase("granite-20b", fsdp=True),
    # 6 query heads on 4 ranks: D-split projections, query rows over
    # "model" under sequence parallelism; vocab 258: the D-split head
    "phi4-mini-3.8b/1x4": TrainCase("phi4-mini-3.8b", "1x4", hints=True,
                                    config=(("vocab_size", 258),)),
    # MLA, shared experts, dense layer 0
    "deepseek": TrainCase("deepseek-v2-236b", hints=True),
    # Mamba channel-parallel (in_proj regrouped), GQA, MoE
    "jamba": TrainCase("jamba-v0.1-52b", hints=True),
    # mLSTM over heads, sLSTM over channels
    "xlstm": TrainCase("xlstm-125m"),
    # 2 heads on 4 ranks: the mLSTM state along the key index
    "xlstm/dh/1x4": TrainCase("xlstm-125m", "1x4", config=(("n_heads", 2), ("n_kv_heads", 2))),
    # the encoder, cacheless heads-parallel cross attention
    "seamless": TrainCase("seamless-m4t-large-v2"),
    # 6 experts on 4 ranks: the routed experts split over F (partial sums)
    "granite-moe/F/1x4": TrainCase(GRANITE, "1x4", hints=True, moe=(("n_experts", 6),)),
}


def case_cfg(case: TrainCase):
    """The case's smoke config in fp32 (the dense archs at their
    published G; granite at CAPACITY_FACTOR)."""
    cfg = reduce_for_smoke(get_config(case.arch))
    if case.arch in DENSE:
        cfg = keep_groups(cfg, get_config(case.arch))
    cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32",
                              moe_backend="ref", **dict(case.config))
    if case.arch == GRANITE:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=CAPACITY_FACTOR, **dict(case.moe)))
    return cfg


def granite_cfg():
    return case_cfg(TRAIN_CASES["2x2"])


def case_params(cfg):
    """The params every case starts from (the test bridges them to the
    reference): the port's seeded init on the CPU."""
    return init_params(0, cfg, device="cpu")


def case_batch(cfg, i: int) -> dict:
    """Batch i of the case's corpus (seed 0), frames for seamless."""
    batch = SyntheticCorpus(cfg.vocab_size, seed=0).batch(i, B, S)
    if cfg.encdec is not None:
        rng = np.random.default_rng(100 + i)
        batch["frames"] = (rng.standard_normal((B, cfg.encdec.frontend_frames, cfg.d_model))
                           * 0.02).astype(np.float32)
    return batch


def state_dir(io: Path, name: str) -> Path:
    return io / ("state_" + name.replace("/", "_"))


def deepseek_cfg():
    cfg = reduce_for_smoke(get_config("deepseek-v2-236b"))
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")


def train_cases(io: Path, rank: int, results: dict) -> None:
    """Each case: the state sharded on its mesh, one mesh value-and-grad
    (loss, counts) on batch 0, then STEPS mesh train steps; the final
    state is saved whole (rank 0 writes). The (2, 2) granite step records
    its collectives (`dims` of each all-gather, for the test's check that
    no model-split leaf is gathered whole)."""
    from repro_torch.launch.dryrun import CollectiveCounter

    for name, case in TRAIN_CASES.items():
        cfg = case_cfg(case)
        params = case_params(cfg)
        mesh = make_mesh(*MESHES[case.mesh], "cpu")
        set_moe_sharding_hints(enable=case.hints)
        att.set_sequence_parallel(mesh if case.hints else None)
        opt_cfg = AdamWConfig(compression=case.compression, grad_clip=GRAD_CLIP)
        threshold = shd.FSDP_THRESHOLD
        if case.fsdp:  # the smoke config far below it: store it as a large arch's
            shd.FSDP_THRESHOLD = 0
        ps, os_ = shard_train_state(params, adamw_init(params, opt_cfg), mesh, cfg)
        specs = shd.tree_pspecs(params, mesh, cfg)
        shd.FSDP_THRESHOLD = threshold
        for path, t in leaves_with_path(ps):  # every shard the shape its spec gives
            spec = shd.spec_leaves(specs)[path]
            assert tuple(t.to_local().shape) == shd.shard_shape(tuple(t.shape), spec, mesh)
            results["shard_shapes"] = results.get("shard_shapes", 0) + 1
        batch0 = {k: torch.as_tensor(v) for k, v in case_batch(cfg, 0).items()}
        places = {p: list(t.placements) for p, t in leaves_with_path(ps)}
        local = tree_map(lambda t: t.to_local(), ps)
        loss, metrics, _ = mesh_value_and_grad(local, cfg, batch0, mesh, places)
        results[f"{name}/loss0"] = float(loss)
        results[f"{name}/counts0"] = metrics["expert_counts"].tolist()
        step = make_train_step(cfg, opt_cfg, case.n_micro, mesh=mesh)
        losses = []
        for i in range(STEPS):
            batch = {k: torch.as_tensor(v) for k, v in case_batch(cfg, i).items()}
            with CollectiveCounter() as coll:
                ps, os_, out = step(ps, os_, batch)
            if name == "2x2" and i == 0:
                results["2x2/gathers"] = [n for kind, _, n in coll.calls if kind == "all-gather"]
            losses.append(float(out["loss"]))
        results[f"{name}/losses"] = losses
        save(str(state_dir(io, name)), STEPS, {"params": ps, "opt": os_})
        set_moe_sharding_hints(enable=False)
        att.set_sequence_parallel(None)
        if name == "2x2":
            reshard(io, cfg, ps, os_, results)


def one_rank(io: Path, results: dict) -> None:
    """The (1, 1) mesh (one gloo rank) against the unsharded step: granite
    and jamba at fp32 smoke size, STEPS steps at AdamW's defaults; every
    param and moment leaf bitwise equal (the card's gate at 1e-6 relative
    runs this on NCCL)."""
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    for arch in (GRANITE, "jamba-v0.1-52b"):
        cfg = case_cfg(TrainCase(arch))
        params = init_params(0, cfg, device="cpu")
        opt_cfg = AdamWConfig()
        plain = make_train_step(cfg, opt_cfg)
        p, o = params, adamw_init(params, opt_cfg)
        step = make_train_step(cfg, opt_cfg, mesh=mesh)
        mp, mo = shard_train_state(params, adamw_init(params, opt_cfg), mesh, cfg)
        for i in range(STEPS):
            batch = {k: torch.as_tensor(v) for k, v in case_batch(cfg, i).items()}
            p, o, out = plain(p, o, batch)
            mp, mo, mout = step(mp, mo, batch)
            assert torch.equal(out["loss"], mout["loss"]), (arch, i)
        n = 0
        for want, got in ((p, mp), (o["m"], mo["m"]), (o["v"], mo["v"])):
            for (path, a), (_, b) in zip(leaves_with_path(want), leaves_with_path(got)):
                assert torch.equal(a, b.full_tensor()), (arch, path)
                n += 1
        results[f"one_rank/{arch}"] = n


def reshard(io: Path, cfg, ps, os_, results: dict) -> None:
    """The (2, 2) state's checkpoint restored onto a (4, 1) mesh: every
    rank's shards bitwise equal to the same chunks of the saved state."""
    mesh = make_mesh((4, 1), ("data", "model"), "cpu")
    full = tree_map(lambda t: t.full_tensor(), {"params": ps, "opt": os_})
    specs = shd.tree_pspecs(full["params"], mesh, cfg)
    shardings = {"params": shd.named_shardings(mesh, specs),
                 "opt": shd.named_shardings(mesh, shd.opt_state_pspecs(full["opt"], specs))}
    got = restore(str(io / "state_2x2"), STEPS, full, shardings)
    for (path, t), (_, f) in zip(leaves_with_path(got), leaves_with_path(full)):
        want = shd.local_chunk(f, mesh, t.placements)
        assert torch.equal(t.to_local(), want), path
        results["resharded_leaves"] = results.get("resharded_leaves", 0) + 1


def grouped_hints(rank: int, results: dict) -> None:
    """The grouped dispatch with the hints on (1, 4) and (2, 2) meshes (rows
    over "data", this rank's E/m experts) equal to it without them: rows,
    counts, aux loss, and the gradients of x, the router and the experts
    (those summed over the data shards)."""
    cfg = granite_cfg()
    p = init_moe(make_generator(3, "cpu"), cfg)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(B, 16, cfg.d_model, generator=gen)
    dy = torch.randn(B, 16, cfg.d_model, generator=gen)

    def run(p, x, dy):
        p = {k: v.detach().requires_grad_() for k, v in p.items()}
        x = x.detach().requires_grad_()
        out = moe_forward(p, cfg, x, grouped=True)
        (out.y * dy).sum().add(out.aux_loss).backward()
        return out, x.grad, {k: v.grad for k, v in p.items()}

    want, gx, gp = run(p, x, dy)
    for shape in ((1, 4), (2, 2)):
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        dp, n_dp, i_dp = shd.dp_group(mesh)
        _, m, i_m = shd.axis_group(mesh, "model")
        n = cfg.moe.n_experts // m
        mine = slice(i_m * n, (i_m + 1) * n)
        local = {k: (v[mine] if k != "router" else v) for k, v in p.items()}
        step = B // n_dp
        rows = slice(i_dp * step, (i_dp + 1) * step)
        set_moe_sharding_hints(enable=True)
        with shd.use_mesh(mesh):
            got, lx, lp = run(local, x[rows], dy[rows])
        set_moe_sharding_hints(enable=False)
        pairs = {"y": (got.y, want.y[rows]), "aux": (got.aux_loss, want.aux_loss),
                 "dx": (lx, gx[rows])}
        for k, g in lp.items():  # this rank's rows' part, summed over the data shards
            pairs[f"d{k}"] = (all_reduce(g, dp), gp[k] if k == "router" else gp[k][mine])
        assert torch.equal(got.expert_counts, want.expert_counts)
        # fp32 sums in another order: relative to each quantity's largest element
        err = max(float((a - b).abs().max() / b.abs().max()) for a, b in
                  ((a.detach(), b.detach()) for a, b in pairs.values()))
        assert err < 1e-5, (shape, {k: float((a - b).abs().max()) for k, (a, b) in pairs.items()})
        results[f"grouped_hints/{shape[0]}x{shape[1]}/max_err"] = err


def seq_parallel(io: Path, rank: int, results: dict) -> None:
    """GQA (6 heads over 4 ranks) and absorbed MLA with the query rows split
    over "model" of a (1, 4) mesh; rank 0 keeps the outputs."""
    data = np.load(io / "arrays.npz")
    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    q, k, v = (torch.from_numpy(data[n]) for n in ("q", "k", "v"))
    cfg = deepseek_cfg()
    like = {"p": att.init_mla(make_generator(0, "cpu"), cfg),
            "x": torch.zeros(data["mla_x_shape"].tolist())}
    mla = restore(str(io / "mla"), 0, like)
    pos = torch.arange(mla["x"].shape[1])[None, :]
    att.set_sequence_parallel(mesh)
    gqa = att._grouped_attention(q, k, v, causal=True, q_chunk=8)
    out, _ = att.mla_forward(mla["p"], cfg, mla["x"], pos)
    att.set_sequence_parallel(None)
    results["arrays"].update(seq_gqa=gqa.numpy(), seq_mla=out.numpy())


def reduces(io: Path, rank: int, results: dict) -> None:
    """compressed_psum over the world for each method, and
    cross_pod_grad_reduce on a (2, 1, 2) mesh (identity on (2, 2))."""
    xs = np.load(io / "arrays.npz")["psum_x"]
    x = torch.from_numpy(xs[rank])
    world = dist.group.WORLD
    gathered = {}
    for method in ("int8", "bf16", "none"):
        got = compressed_psum(x, world, method)
        gathered[f"psum_{method}"] = got.float().numpy()
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"), "cpu")
    red = cross_pod_grad_reduce({"g": x}, mesh, "int8")["g"]
    flat = make_mesh((2, 2), ("data", "model"), "cpu")
    assert cross_pod_grad_reduce({"g": x}, flat, "int8")["g"] is x
    # every rank's result, gathered to rank 0
    for name, arr in [*gathered.items(), ("pod_reduce", red.numpy())]:
        parts = [torch.empty_like(torch.from_numpy(arr)) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, torch.from_numpy(arr))
        results["arrays"][name] = torch.stack(parts).numpy()


def main(rank: int, world: int, init_file: str, io_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    io = Path(io_dir)
    results = {"arrays": {}}
    if world == 1:
        one_rank(io, results)
    else:
        train_cases(io, rank, results)
        grouped_hints(rank, results)
        seq_parallel(io, rank, results)
        reduces(io, rank, results)
    dist.barrier()
    if rank == 0:
        np.savez(io / "out_arrays.npz", **results.pop("arrays"))
        (io / "out.json").write_text(json.dumps(results))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
