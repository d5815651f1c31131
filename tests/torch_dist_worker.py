"""One rank of the 4-process gloo world that tests/test_torch_distributed.py
spawns (imports torch and the port only):

  python tests/torch_dist_worker.py RANK WORLD INIT_FILE IO_DIR

Reads its inputs from IO_DIR (written by the test), holds what compares
the port with itself (local shard shapes, the hinted grouped dispatch vs
the unhinted one with its gradients, a checkpoint restored onto another
mesh), and has rank 0 write what the test compares with the JAX package
(train states, sequence-parallel attention, compressed reduces). Any
failed check raises, so the rank exits non-zero."""
import dataclasses
import datetime
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

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
# name -> (mesh shape, dim names, compression, MoE hints and sequence
# parallelism, microbatches)
TRAIN_CASES = {
    "2x2": ((2, 2), ("data", "model"), "none", True, 1),
    "2x1x2": ((2, 1, 2), ("pod", "data", "model"), "int8_ef", False, 2),
}


def granite_cfg():
    cfg = reduce_for_smoke(get_config("granite-moe-1b-a400m"))
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32",
                               moe=dataclasses.replace(cfg.moe,
                                                       capacity_factor=CAPACITY_FACTOR))


def deepseek_cfg():
    cfg = reduce_for_smoke(get_config("deepseek-v2-236b"))
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")


def train_cases(io: Path, rank: int, results: dict) -> None:
    """Each case: the state sharded on its mesh, one mesh value-and-grad
    (loss, counts) on batch 0, then STEPS mesh train steps; the final
    state is saved whole (rank 0 writes)."""
    cfg = granite_cfg()
    like = init_params(0, cfg, device="cpu")
    params = restore(str(io / "params"), 0, like)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    for name, (shape, names, comp, hints, n_micro) in TRAIN_CASES.items():
        mesh = make_mesh(shape, names, "cpu")
        set_moe_sharding_hints(enable=hints)
        att.set_sequence_parallel(mesh if hints else None)
        opt_cfg = AdamWConfig(compression=comp, grad_clip=GRAD_CLIP)
        ps, os_ = shard_train_state(params, adamw_init(params, opt_cfg), mesh, cfg)
        specs = shd.tree_pspecs(params, mesh, cfg)
        for path, t in leaves_with_path(ps):  # every shard the shape its spec gives
            spec = shd.spec_leaves(specs)[path]
            assert tuple(t.to_local().shape) == shd.shard_shape(tuple(t.shape), spec, mesh)
            results["shard_shapes"] = results.get("shard_shapes", 0) + 1
        batch0 = {k: torch.as_tensor(v) for k, v in corpus.batch(0, B, S).items()}
        places = {p: list(t.placements) for p, t in leaves_with_path(ps)}
        local = tree_map(lambda t: t.to_local(), ps)
        loss, metrics, _ = mesh_value_and_grad(local, cfg, batch0, mesh, places)
        results[f"{name}/loss0"] = float(loss)
        results[f"{name}/counts0"] = metrics["expert_counts"].tolist()
        step = make_train_step(cfg, opt_cfg, n_micro, mesh=mesh)
        losses = []
        for i in range(STEPS):
            batch = {k: torch.as_tensor(v) for k, v in corpus.batch(i, B, S).items()}
            ps, os_, out = step(ps, os_, batch)
            losses.append(float(out["loss"]))
        results[f"{name}/losses"] = losses
        save(str(io / f"state_{name}"), STEPS, {"params": ps, "opt": os_})
        set_moe_sharding_hints(enable=False)
        att.set_sequence_parallel(None)
        if name == "2x2":
            reshard(io, cfg, ps, os_, results)


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
