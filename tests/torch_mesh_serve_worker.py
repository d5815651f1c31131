"""One rank of the 4-process gloo world that tests/test_torch_mesh_serve.py
spawns (imports torch and the port only):

  python tests/torch_mesh_serve_worker.py RANK WORLD INIT_FILE IO_DIR MODE

MODE "serve": for every case of CASES on every mesh it names, the rank takes its rows
of the batch (all of them where the batch does not split over DP), runs
the port's mesh `prefill` (an encoder-decoder's over its rows' frames)
and DECODE_STEPS mesh `decode_step`s (greedy: each row's next token is
the argmax of its own logits), records every collective of the decode
steps, and gathers the rows, logits, counts and cache shards for rank 0
to write (those gathers are the test's, outside the recorded steps), and
holds the mesh train step's gradients on a stacked MLP split over its
layers to the unsharded step's. MODE "dryrun": each of the dry-run's
smoke cells (DRYRUN_CELLS) once on (2, 2), the step the dry-run builds,
under CommDebugMode and the dry-run's CollectiveCounter
(tests/test_torch_dryrun.py). Any failed check raises, so the rank exits
non-zero; `spawn_world` runs a world."""
import dataclasses
import datetime
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import keep_groups  # noqa: E402
from repro_torch.checkpoint import restore  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.layers import make_generator  # noqa: E402
from repro_torch.models.model import decode_step, init_params, prefill  # noqa: E402
from repro_torch.serving.engine import init_tiered_for_model, strip_expert_weights  # noqa: E402
from repro_torch.serving.tiered_moe import TierSizes  # noqa: E402
from repro_torch.tree import leaves_with_path, tree_map  # noqa: E402

B, S, CACHE, DECODE_STEPS = 4, 8, 32, 4
MESHES = {"2x2": ((2, 2), ("data", "model")), "1x4": ((1, 4), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
ALL = tuple(MESHES)
DENSE = ("llama3.2-3b", "phi4-mini-3.8b", "qwen2.5-32b", "chameleon-34b", "granite-20b")


@dataclasses.dataclass(frozen=True)
class Case:
    arch: str
    meshes: tuple = ALL
    sizes: tuple | None = None  # tier sizes; None: the flat MoE on full params
    pad: int = 16  # the cold pool's padding
    frac: float = 0.25  # cold_capacity_frac
    masked: bool = True  # right-padded prompts (token_mask), else exact length
    fsdp: bool = False  # params also split over "data"
    batch: int = B  # the last `batch` of the B prompts (1: whole on every DP rank)
    config: tuple = ()  # (field, value) pairs over the smoke config


CASES = {
    **{a: Case(a) for a in DENSE},
    "granite-20b/fsdp": Case("granite-20b", ("2x2",), fsdp=True),
    # cold homed over data x model on (2, 2); warm F striped
    "granite-moe/tiers": Case("granite-moe-1b-a400m", sizes=(2, 2, 4), pad=4),
    # 6 cold slots: homed over data with F striped on (2, 2), F striped on (1, 4)
    "granite-moe/cold-data": Case("granite-moe-1b-a400m", sizes=(1, 1, 6), pad=2),
    # the cold tier drops at capacity: positions over the DP shards
    "granite-moe/drops": Case("granite-moe-1b-a400m", ("2x2", "2x1x2"), sizes=(2, 2, 4),
                              pad=4, frac=0.05),
    # the flat MoE (expert-parallel) at its capacity factor: exact-length prefill
    "granite-moe/flat": Case("granite-moe-1b-a400m", masked=False),
    "deepseek/tiers": Case("deepseek-v2-236b", sizes=(2, 2, 4), pad=4),
    "deepseek/flat": Case("deepseek-v2-236b", masked=False),
    # Mamba channel-parallel, its GQA layer and tiered MoE layers
    "jamba/tiers": Case("jamba-v0.1-52b", sizes=(2, 2, 4), pad=4),
    # a batch of 1 on 2 DP ranks: rows, cache and tier work whole on both
    "jamba/batch1": Case("jamba-v0.1-52b", ("2x2",), sizes=(2, 2, 4), pad=4, batch=1),
    "granite-moe/batch1": Case("granite-moe-1b-a400m", ("2x2",), sizes=(2, 2, 4), pad=4,
                               batch=1),
    # 4 heads: the mLSTM state splits over heads on every mesh
    "xlstm": Case("xlstm-125m"),
    # 2 heads: on (1, 4) C and n split along the key index (the published
    # 4 heads on 16 ranks), over heads on the 2-wide meshes
    "xlstm/dh": Case("xlstm-125m", config=(("n_heads", 2), ("n_kv_heads", 2))),
    # 16 frames over "model"; a vocab of 258: vocab-parallel on 2 model
    # ranks, the D-split embedding and head on 4
    "seamless": Case("seamless-m4t-large-v2", config=(("vocab_size", 258),)),
}
# the dry-run's smoke cells, traced on a fake (2, 2) world by the test
DRYRUN_CELLS = {
    "granite": dict(arch="granite-moe-1b-a400m", kind="decode", batch=4, seq=16,
                    sizes=(2, 2, 4)),
    "jamba": dict(arch="jamba-v0.1-52b", kind="decode", batch=4, seq=16, sizes=(2, 2, 4)),
    "seamless": dict(arch="seamless-m4t-large-v2", kind="prefill", batch=4, seq=16,
                     sizes=None),
    # the mesh train step (forward, backward, AdamW) under the MoE hints
    "granite_train": dict(arch="granite-moe-1b-a400m", kind="train", batch=4, seq=1024,
                          sizes=None),
}


def port_cfg(arch: str, config: tuple = ()):
    """The smoke config in fp32 (with the `config` fields set): the dense
    archs keep their published G."""
    cfg = reduce_for_smoke(get_config(arch))
    if arch in DENSE:
        return keep_groups(cfg, get_config(arch))
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32",
                               moe_backend="ref", **dict(config))


def frames(cfg, seed: int = 2):
    """An encoder-decoder's frames [B, F, D] fp32 (0.02 N(0, 1), as the
    reference's `add_frames` scales them), else None."""
    if cfg.encdec is None:
        return None
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, cfg.encdec.frontend_frames, cfg.d_model)) * 0.02).astype(
        np.float32)


def prompts(vocab: int, seed: int = 0):
    """tokens [B, S] and lengths [B] (S on every row when unmasked)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    lens = np.array([S, 5, 3, 7], dtype=np.int32)
    return toks, lens


def _gather_rows(x: torch.Tensor, dp) -> torch.Tensor:
    """The whole batch from every DP shard's rows (the test's gather)."""
    group, n, _ = dp
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def _full_cache(cache) -> dict:
    """Every cache leaf whole, copied: a replicated DTensor's `full_tensor`
    is its local tensor, which the next decode step writes in place."""
    return {"|".join(path): t.full_tensor().numpy().copy() for path, t in leaves_with_path(cache)}


def _too_big(cache, tiered, rows: int) -> set:
    """The dims (sorted) of an all-gather of a cache leaf (this rank's
    rows, every key or channel) or of a tier buffer (one layer, whole).
    Not sLSTM's state leaves c, n, h, m [rows, D]: the whole h that each
    step's h @ r needs has their size, one all-gather a step."""
    out = set()
    slstm = {path[:-1] for path, _ in leaves_with_path(cache) if path[-1] == "c"}
    for path, t in leaves_with_path(cache):
        if path[:-1] in slstm:
            continue
        shape = list(t.shape[1:] if "stack" in path else t.shape)
        shape[0] = rows
        out.add(tuple(sorted(shape)))
    for path, t in leaves_with_path(tiered or {}):
        if path[-1] in ("hot", "warm", "cold"):
            out.add(tuple(sorted(t.shape[1:] if "stack" in path else t.shape)))
    return out


def run_case(name: str, case: Case, mesh_name: str, io: Path, results: dict) -> None:
    cfg = port_cfg(case.arch, case.config)
    mesh = make_mesh(*MESHES[mesh_name], "cpu")
    like = {"params": init_params(0, cfg, device="cpu")}
    if case.sizes is not None:
        like["tiered"] = init_tiered_for_model(make_generator(1, "cpu"), cfg,
                                               TierSizes(*case.sizes), pad_cold_to=case.pad)
    state = restore(str(io / name.replace("/", "_")), 0, like)
    params, tiered = state["params"], state.get("tiered")
    if tiered is not None:
        params = strip_expert_weights(params, cfg)
        tiered = shd.shard_tiered(tiered, mesh)
    params = shd.shard_tree(params, mesh, shd.tree_pspecs(params, mesh, cfg, fsdp=case.fsdp))
    dp = shd.dp_group(mesh, case.batch)
    toks, lens = (torch.from_numpy(a[B - case.batch:]) for a in prompts(cfg.vocab_size))
    mask = (torch.arange(S)[None, :] < lens[:, None]) if case.masked else None
    rows = shd.shard_rows(torch.arange(case.batch), mesh)
    fr = frames(cfg)
    fr = None if fr is None else torch.from_numpy(fr[B - case.batch:])[rows]
    kw = dict(tiered=tiered, cold_capacity_frac=case.frac, mesh=mesh)
    logits, cache = prefill(params, cfg, toks[rows], CACHE,
                            token_mask=None if mask is None else mask[rows], frames=fr,
                            batch=case.batch, **kw)
    key = f"{name}@{mesh_name}"
    arrays = {f"{key}/prefill_logits": _gather_rows(logits, dp).numpy()}
    arrays.update({f"{key}/prefill_cache/{k}": v for k, v in _full_cache(cache).items()})
    pos = (lens if case.masked else torch.full((case.batch,), S, dtype=torch.int32))[rows]
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    big = _too_big(cache, tiered, rows.numel())
    out_toks, out_logits, out_counts, gathers = [], [], [], []
    for step in range(DECODE_STEPS):
        out_toks.append(_gather_rows(tok, dp))
        with dryrun.CollectiveCounter() as coll:
            logits, cache, counts = decode_step(params, cfg, tok, cache, pos + step, **kw)
        gathers += [tuple(sorted(dims)) for kind, dims, _ in coll.calls
                    if kind == "all-gather" and dims is not None]
        out_logits.append(_gather_rows(logits, dp))
        out_counts.append(counts)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
    arrays[f"{key}/tokens"] = torch.stack(out_toks).numpy()
    arrays[f"{key}/decode_logits"] = torch.stack(out_logits).numpy()
    arrays[f"{key}/counts"] = torch.stack(out_counts).numpy()
    arrays.update({f"{key}/decode_cache/{k}": v for k, v in _full_cache(cache).items()})
    results["gathers"][key] = {"n": len(gathers), "cache_or_tier": sorted(set(gathers) & big)}
    assert gathers, key  # the decode step gathers (heads, rows, logits)
    results["arrays"].update(arrays)


def train_stacked_split(results: dict) -> None:
    """The mesh train step's gradients where the rules split a stacked
    dense MLP over its layers (llama's smoke stack [4, D, F] read as 4
    experts on a 2-wide "model" axis) against the unsharded step's."""
    from repro_torch.training import mesh_value_and_grad, value_and_grad

    cfg = port_cfg("llama3.2-3b")
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    params = init_params(0, cfg, device="cpu")
    specs = shd.spec_leaves(shd.tree_pspecs(params, mesh, cfg))
    assert specs[("stack", "slot0", "ffn", "w_gate")][0] == "model", specs
    gen = torch.Generator().manual_seed(3)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
             for k in ("tokens", "labels")}
    loss, _, grads = value_and_grad(params, cfg, batch)
    dt = shd.shard_tree(params, mesh, shd.tree_pspecs(params, mesh, cfg))
    places = {path: list(t.placements) for path, t in leaves_with_path(dt)}
    local = tree_map(lambda t: t.to_local(), dt)
    m_loss, _, m_grads = mesh_value_and_grad(local, cfg, batch, mesh, places)
    err = float(abs(m_loss - loss) / abs(loss))
    for (path, g), (_, want) in zip(leaves_with_path(m_grads), leaves_with_path(grads)):
        w = shd.local_chunk(want, mesh, places[path])
        err = max(err, float((g - w).abs().max() / w.abs().max().clamp_min(1e-30)))
    results["train_stacked_split_err"] = err


def dryrun_cells(results: dict) -> None:
    """Each of the dry-run's smoke cells on (2, 2): the step it traces
    (zeros, as the trace builds them), run once under CommDebugMode and
    CollectiveCounter."""
    from torch.distributed.tensor.debug import CommDebugMode

    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    results["dryrun_cells"] = {}
    for name, c in DRYRUN_CELLS.items():
        cfg = port_cfg(c["arch"])
        sizes = None if c["sizes"] is None else TierSizes(*c["sizes"])
        likes = dryrun._likes(cfg, c["kind"], c["batch"], c["seq"], sizes)
        run, _ = dryrun._step(cfg, c["kind"], c["batch"], c["seq"], mesh, likes, "cpu")
        with CommDebugMode() as comm, dryrun.CollectiveCounter() as coll:
            run()
        counts = {}
        for op, n in comm.get_comm_counts().items():
            kind = dryrun.collective_kind(op)
            assert kind is not None, op
            counts[kind] = counts.get(kind, 0) + n
        results["dryrun_cells"][name] = {"comm_debug_counts": counts, "counter": coll.report()}


def main(rank: int, world: int, init_file: str, io_dir: str, mode: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    io = Path(io_dir)
    results = {"arrays": {}, "gathers": {}}
    with torch.no_grad():
        if mode == "serve":
            for name, case in CASES.items():
                for mesh_name in case.meshes:
                    run_case(name, case, mesh_name, io, results)
            train_stacked_split(results)
        else:
            dryrun_cells(results)
    dist.barrier()
    if rank == 0:
        np.savez(io / "out_arrays.npz", **results.pop("arrays"))
        (io / "out.json").write_text(json.dumps(results))
    dist.destroy_process_group()


def spawn_world(io: Path, mode: str, deadline_s: float, world: int = 4) -> dict:
    """Run `world` ranks of this worker in `mode` ("serve": every case,
    "dryrun": the dry-run cell), joined through a file in `io`, and wait
    up to `deadline_s`: rank 0's results, or an AssertionError with the
    ranks' logs if a rank failed or is still running (then killed)."""
    import os
    import subprocess
    import time

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    logs = [open(io / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world), str(io / "init"),
                               str(io), mode], env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(world)]
    end = time.time() + deadline_s
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
                     for r in range(world))
    why = (f"ranks {failed} failed (ranks {running} stopped)" if failed
           else f"ranks {running} still running after {deadline_s} s")
    assert not failed and not running, why + "\n" + text
    out = json.loads((io / "out.json").read_text())
    return {**out, "arrays": dict(np.load(io / "out_arrays.npz"))}


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
