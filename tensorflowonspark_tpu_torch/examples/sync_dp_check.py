"""Synchronous data parallelism across processes: the eager step against
the captured train loop, with global BatchNorm statistics and metrics.

Spawns ``--world`` ranks (one CUDA device each over NCCL with ``--platform
gpu``, the CPU over gloo with ``--platform cpu``). Each rank builds the
model from seed 0 and trains on its own share of the same global batches
(seeded), first ``--steps`` eager steps (``compile_train_step``), then,
from the same weights, the same steps through ``compile_train_loop`` (on
the card: two eager warm-up steps, one step captured in a CUDA graph with
its all-reduces — the BN reductions' f64 sums, the gradients and the
metrics — and replays). On the card cuDNN runs deterministic. Rank 0
prints one JSON line per model:

* the loss each rank reports (equal on every rank: the global batch's);
* the tensors (parameters and BN statistics) in which the loop differs
  from the eager steps (none: bitwise equal), and in which any rank differs
  from rank 0;
* the launches each counted kernel wrapper makes in the loop run (on the
  card: the two warm-up steps' and the capture's, since a replay calls no
  wrapper; the BN reductions in their split mode, ``bn_finish`` twice a BN
  layer a step);
* eager and captured step ms (host clock, a device sync after each call),
  ``--pairs`` pairs in turns, medians and ranges.

With ``--fsdp`` each model also trains, from the same weights on the same
batches, on meshes over the ranks with the parameters and the optimizer
state sharded along ``fsdp`` (ZeRO-3, ``SyncDataParallel(mesh,
fsdp=True)``): ``dp`` = world/2 × ``fsdp`` = 2 (from 4 ranks) and ``dp`` =
1 × ``fsdp`` = world. Each such leg's line adds its losses' relative gap to
the data-parallel leg's (with ``--dtype float32`` held within 1e-5 after
the steps: the sums only run in other orders), each rank's optimizer-state
bytes and peak memory (``max_memory_allocated``), and the parameters
sharded. Every leg's gathered parameters must be equal on every rank.

With ``--tp`` the LM trains (from the same weights, on a global batch of
8 rows split over each leg's data axes) on the model axes too: ``dp`` =
world/2 × ``tp`` = 2, ``tp`` = world, and ``dp`` × ``fsdp`` = 2 × ``tp`` = 2
(ZeRO-3 over the tp blocks), beside the data-parallel leg on the same rows;
with ``--ep`` the LM with 8 experts (``transformer_moe``) on ``ep`` = world
and ``dp`` = world/2 × ``ep`` = 2 beside its data-parallel leg. The model is
built on each leg's mesh from this rank's blocks
(``transformer.create_model(mesh=...)``). Their lines add the parameters
split over a model axis and each rank's parameter bytes; every rank's
parameters, gathered to full tensors, must be equal, so the arrays no model
axis splits are equal on every rank of a group.

With ``--sp`` the LM trains sequence-parallel (ring attention through the
flash kernels, each rank of an ``sp`` group on its block of every row:
``sharding.sequence_chunk``) on ``sp`` = world, ``dp`` = world/2 × ``sp``
= 2, ``tp`` = 2 × ``sp`` = world/2 and ``fsdp`` = 2 × ``sp`` = world/2
beside its data-parallel leg on the same 8 rows (``transformer_sp``). With
``--sp_long`` one long-context leg follows: ``sp`` = world on ``LONG_ROWS``
rows of ``LONG_SEQ`` tokens (``transformer_sp_long``): its step ms (host
clock, a sync after each step), tokens/s, each rank's peak memory, and its
first loss against the same rows' on one rank at full length (no ring, the
flash kernels), within ``LONG_LOSS_TOL`` relative.

``--models`` picks the models (default ``resnet50,transformer``); ``--tp``,
``--ep`` and ``--sp`` add theirs.

Usage (four cards of one host, full ResNet-50 and the full-width LM)::

    python -m tensorflowonspark_tpu_torch.examples.sync_dp_check --world 4 [--fsdp] [--tp] [--ep] [--sp]

and a rehearsal on the CPU at a small size::

    python -m tensorflowonspark_tpu_torch.examples.sync_dp_check --platform cpu \\
        --world 4 --size small --steps 3 --pairs 0 [--fsdp] [--tp] [--ep] [--sp] [--sp_long]
"""

import argparse
import json
import os
import statistics
import tempfile
import time

#: the ZeRO-3 rule's least sharded size: the JAX package's default at full
#: size; smaller at the small size, so that its layers shard too
MIN_WEIGHT_SIZE = {"full": 2 ** 14, "small": 2 ** 10}
#: full size: the two slices' models and per-card batches
FULL = {"resnet50": dict(batch=64, image=224), "transformer": dict(batch=8, seq=2048)}
SMALL = {"resnet50": dict(batch=4, image=32), "transformer": dict(batch=2, seq=64)}


#: the loss gap of a ZeRO-3, tp or ep leg to the data-parallel leg in float32
REL_TOL = 1e-5
#: the model-axes legs' global batch (rows), split over each leg's data axes
AXES_ROWS = {"full": 8, "small": 4}
#: the mixture's experts
EXPERTS = 8
#: the long-context leg: rows and sequence length, and its first loss
#: against one rank's at full length (the LM's bf16 loss limit)
LONG_ROWS, LONG_SEQ, LONG_LOSS_TOL = 2, {"full": 16384, "small": 256}, 2e-4


def _legs(model, world, fsdp):
    """``[(name, mesh axes or None, fsdp)]``: the data-parallel leg (a
    replica a process, no mesh), then with ``fsdp`` the ZeRO-3 meshes; for
    ``transformer_tp`` and ``transformer_moe`` their model-axes meshes."""
    legs = [("dp", None, False)]
    half = world >= 4 and world % 2 == 0
    if model == "transformer_tp":
        if half:
            legs.append(("dp{}_tp2".format(world // 2), {"dp": world // 2, "tp": 2}, False))
        legs.append(("tp{}".format(world), {"dp": 1, "tp": world}, False))
        if world >= 4 and world % 4 == 0:
            legs.append(("dp{}_fsdp2_tp2".format(world // 4), {"dp": world // 4, "fsdp": 2, "tp": 2}, True))
    elif model == "transformer_moe":
        legs.append(("ep{}".format(world), {"dp": 1, "ep": world}, False))
        if half:
            legs.append(("dp{}_ep2".format(world // 2), {"dp": world // 2, "ep": 2}, False))
    elif model == "transformer_sp":
        legs.append(("sp{}".format(world), {"dp": 1, "sp": world}, False))
        if half:
            legs.append(("dp{}_sp2".format(world // 2), {"dp": world // 2, "sp": 2}, False))
            legs.append(("tp2_sp{}".format(world // 2), {"dp": 1, "tp": 2, "sp": world // 2}, False))
            legs.append(("fsdp2_sp{}".format(world // 2), {"dp": 1, "fsdp": 2, "sp": world // 2}, True))
    elif fsdp:
        if half:
            legs.append(("dp{}_fsdp2".format(world // 2), {"dp": world // 2, "fsdp": 2}, True))
        legs.append(("fsdp{}".format(world), {"dp": 1, "fsdp": world}, True))
    return legs


def _models(size, device, dtype_name, names):
    """``{name: (build(mesh), loss_fn, optimizer factory, loop kwargs,
    global batch maker(rng, world))}`` for the slices' models in
    ``names``: ``resnet50`` and ``transformer`` (a per-rank batch a rank),
    ``transformer_tp`` and ``transformer_moe`` (``AXES_ROWS`` rows in
    all)."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.models import resnet, transformer
    from tensorflowonspark_tpu_torch.train import optim

    dims = FULL if size == "full" else SMALL
    dtype = getattr(torch, dtype_name)

    def resnet_build(mesh=None):
        if size == "full":
            return resnet.resnet50(dtype=dtype, bn_impl="pallas", generator=torch.Generator().manual_seed(0))
        return resnet.ResNet((1, 1), (8, 16), num_classes=10, bottleneck=True, stem="imagenet",
                             dtype=dtype, bn_impl="pallas", generator=torch.Generator().manual_seed(0))

    def resnet_batch(rng, world):
        n, px = dims["resnet50"]["batch"] * world, dims["resnet50"]["image"]
        classes = 1000 if size == "full" else 10
        return {"image": rng.standard_normal((n, px, px, 3)).astype(np.float32),
                "label": rng.integers(0, classes, n)}

    lm_cfg = (dict(vocab_size=32000, d_model=512, n_layers=6, n_heads=8, d_ff=2048) if size == "full"
              else dict(vocab_size=300, d_model=64, n_layers=2, n_heads=2, d_ff=128))

    def lm_build(mesh=None, **over):
        return transformer.create_model(mesh=mesh, dtype=dtype_name,
                                        generator=torch.Generator().manual_seed(0),
                                        **dict(dict(lm_cfg, max_seq_len=dims["transformer"]["seq"]), **over))

    # groups of 256 tokens at full size (the JAX default), of a row at the
    # small: a divisor of every rank's token count on every leg
    moe = dict(moe_experts=EXPERTS, moe_group_size=min(256, dims["transformer"]["seq"]))

    def lm_batch(rng, world, rows=None, seq=None):
        n, length = rows or dims["transformer"]["batch"] * world, (seq or dims["transformer"]["seq"]) + 1
        tokens = rng.integers(1, lm_cfg["vocab_size"], (n, length)).astype(np.int32)
        cut = length // 3
        seg = np.where(np.arange(length) < cut, 1, 2)[None].repeat(n, 0).astype(np.int32)
        pos = np.concatenate([np.arange(cut), np.arange(length - cut)])[None].repeat(n, 0).astype(np.int32)
        return {"tokens": tokens, "segment_ids": seg, "positions": pos}

    rows = AXES_ROWS[size]
    models = {
        "resnet50": (resnet_build, resnet.make_loss_fn(weight_decay=1e-4),
                     lambda: optim.sgd(optim.linear_schedule(0.0, 0.1, 5), momentum=0.9),
                     dict(mutable=True), resnet_batch),
        "transformer": (lm_build, transformer.make_loss_fn(None), lambda: optim.adamw(3e-4),
                        dict(has_aux=True), lm_batch),
        "transformer_tp": (lm_build, transformer.make_loss_fn(None), lambda: optim.adamw(3e-4),
                           dict(has_aux=True), lambda rng, world: lm_batch(rng, world, rows)),
        "transformer_moe": (lambda mesh=None: lm_build(mesh, **moe), transformer.make_loss_fn(None),
                            lambda: optim.adamw(3e-4), dict(has_aux=True),
                            lambda rng, world: lm_batch(rng, world, rows)),
        "transformer_sp": (lm_build, transformer.make_loss_fn(None), lambda: optim.adamw(3e-4),
                           dict(has_aux=True), lambda rng, world: lm_batch(rng, world, rows)),
        "transformer_sp_long": (lambda mesh=None: lm_build(mesh, max_seq_len=LONG_SEQ[size]),
                                transformer.make_loss_fn(None), lambda: optim.adamw(3e-4), dict(has_aux=True),
                                lambda rng, world: lm_batch(rng, world, LONG_ROWS, LONG_SEQ[size])),
    }
    return {name: models[name] for name in names}


def _strategy(where, axes, fsdp, size):
    """The leg's strategy: a replica a process, or the mesh with the LM's
    placement rules when it has a model axis."""
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.train import SyncDataParallel

    kw = {"min_weight_size": MIN_WEIGHT_SIZE[size]} if fsdp else {}
    if axes and {"tp", "ep"} & set(axes):
        kw["param_spec_fn"] = transformer.param_specs
    return SyncDataParallel(where, fsdp=fsdp, **kw)


def _full(state):
    """The state's parameters and buffers as full tensors (a model split
    over model axes gathers its blocks: collective)."""
    params = {key: v.detach().clone() for key, v in state.params.items()}
    if state.blocks is not None:
        params = state.blocks.full_tree(params)
    return dict(params, **{key: v.clone() for key, v in state.model_state.items()})


def _rank(rank, world, port, args, out_path):
    import numpy as np
    import torch
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.ops import flash_attention, fused_bn
    from tensorflowonspark_tpu_torch.parallel import build_mesh, sharding

    cuda = args.platform == "gpu"
    if cuda:
        torch.cuda.set_device(rank)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the ranks share the host's cores
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo", init_method="tcp://127.0.0.1:{}".format(port),
                            rank=rank, world_size=world)
    k = args.steps

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def counts():
        return {fn.__name__: fn.launches for fn in fused_bn.COUNTED + flash_attention.KERNELS}

    results = []
    for name, (build, loss_fn, make_opt, kw, make_batch) in _models(args.size, device, args.dtype,
                                                                    args.models).items():
        rng = np.random.default_rng(11)
        glob = [make_batch(rng, world) for _ in range(k)]
        dp_losses = None
        for leg, axes, fsdp in _legs(name, world, args.fsdp):
            where = build_mesh(axes) if axes else device
            strategy = _strategy(where, axes, fsdp, args.size)
            mesh = where if axes and ({"tp", "ep", "sp"} & set(axes)) else None
            index, count = sharding.data_shard(where, rank) if axes else (rank, world)
            block = sharding.sequence_shard(where, rank) if axes else (0, 1)
            share = []
            for batch in glob:
                n = next(iter(batch.values())).shape[0] // count
                rows = {key: v[index * n:(index + 1) * n] for key, v in batch.items()}
                share.append(strategy.shard_batch(sharding.sequence_chunk(rows, *block)))
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
                base = torch.cuda.memory_allocated(device)
            runs = {}
            for side in ("eager", "loop"):
                optimizer = make_opt()
                state = strategy.create_state(lambda: build(mesh), optimizer)
                before = counts()
                losses = []
                if side == "eager":
                    step = strategy.compile_train_step(loss_fn, optimizer, **kw)
                    for b in share:
                        state, metrics = step(state, b)
                        losses.append(metrics["loss"].detach().reshape(1).clone())
                else:
                    loop = strategy.compile_train_loop(loss_fn, optimizer, k, **kw)
                    state, metrics = loop(state, share)
                    losses.append(metrics["loss"].detach().reshape(1).clone())
                sync()
                launches = {key: n - before[key] for key, n in counts().items()}
                runs[side] = (_full(state), torch.cat(losses), launches)
                if side == "eager":
                    timer = (step, state)
                else:
                    timed = (loop, state)
            mismatched = [key for key, v in runs["eager"][0].items() if not torch.equal(v, runs["loop"][0][key])]
            if not torch.equal(runs["eager"][1][-1], runs["loop"][1][-1]):
                mismatched.append("loss")
            off_rank0 = 0
            for key, v in runs["loop"][0].items():
                ref = v.clone()
                dist.broadcast(ref, src=0)
                off_rank0 += int(not torch.equal(ref, v))
            losses = [torch.zeros_like(runs["loop"][1]) for _ in range(world)]
            dist.all_gather(losses, runs["loop"][1])
            walls = {"eager": [], "captured": []}
            step, eager_state = timer
            loop, loop_state = timed
            for _ in range(args.pairs):
                for side in ("eager", "captured"):
                    sync()
                    dist.barrier()
                    t0 = time.perf_counter()
                    if side == "eager":
                        for b in share:
                            eager_state, _ = step(eager_state, b)
                    else:
                        loop_state, _ = loop(loop_state, share)
                    sync()
                    walls[side].append((time.perf_counter() - t0) / k * 1e3)
            eager_losses = [float(v) for v in runs["eager"][1]]
            line = {
                "model": name, "leg": leg, "world": world, "platform": args.platform, "size": args.size,
                "dtype": args.dtype, "steps": k, "batch_per_rank": next(iter(share[0].values())).shape[0],
                "mesh": dict(zip(where.mesh_dim_names, where.mesh.shape)) if axes else None,
                "losses_by_rank": [float(v) for v in losses], "eager_losses": eager_losses,
                "loop_vs_eager_mismatches": mismatched,
                "tensors": len(runs["loop"][0]), "tensors_off_rank0": off_rank0,
                "params_sharded": len(loop_state.sharded.dims) if loop_state.sharded is not None else 0,
                "params_split": len(loop_state.blocks.specs) if loop_state.blocks is not None else 0,
                "param_bytes_per_rank": sum(p.numel() * p.element_size() for p in loop_state.module.parameters()),
                "optimizer_state_bytes_per_rank": sum(
                    t.numel() * t.element_size() for t in _tensors(loop_state.opt_state)),
                "loop_launches": {key: n for key, n in runs["loop"][2].items() if n},
                "eager_launches": {key: n for key, n in runs["eager"][2].items() if n},
                "step_ms": {side: {"median": statistics.median(w), "min": min(w), "max": max(w)}
                            for side, w in walls.items() if w}}
            if cuda:
                peaks = torch.tensor([(torch.cuda.max_memory_allocated(device) - base) / 1e9], device=device)
                gathered = [torch.zeros_like(peaks) for _ in range(world)]
                dist.all_gather(gathered, peaks)
                line["peak_memory_gb_by_rank"] = [float(v) for v in gathered]
            if dp_losses is None:
                dp_losses = eager_losses
            else:
                line["loss_rel_gap_to_dp"] = max(abs(a - b) / abs(b) for a, b in zip(eager_losses, dp_losses))
            results.append(line)
            del runs, timer, timed, step, loop, eager_state, loop_state, share, state
            if cuda:
                torch.cuda.empty_cache()
    if args.sp_long:
        results.append(_long_leg(rank, world, args, device, sync))
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


def _long_leg(rank, world, args, device, sync):
    """The long-context leg: the LM on ``sp`` = world over ``LONG_ROWS``
    rows of ``LONG_SEQ`` tokens, ``args.steps`` eager steps (each timed,
    host clock after a sync), then rank 0 alone computes the first batch's
    loss from the same weights on the whole sequence (no mesh: the flash
    kernels on the card)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.parallel import build_mesh, sharding

    build, loss_fn, make_opt, kw, make_batch = _models(args.size, device, args.dtype, ["transformer_sp_long"])[
        "transformer_sp_long"]
    axes = {"dp": 1, "sp": world}
    where = build_mesh(axes)
    strategy = _strategy(where, axes, False, args.size)
    host = make_batch(np.random.default_rng(12), world)
    batch = strategy.shard_batch(sharding.sequence_chunk(host, *sharding.sequence_shard(where, rank)))
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    optimizer = make_opt()
    state = strategy.create_state(lambda: build(where), optimizer)
    step = strategy.compile_train_step(loss_fn, optimizer, **kw)
    losses, ms = [], []
    for _ in range(args.steps):
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    length = LONG_SEQ[args.size]
    line = {"model": "transformer_sp_long", "leg": "sp{}_long".format(world), "world": world,
            "platform": args.platform, "size": args.size, "dtype": args.dtype, "rows": LONG_ROWS, "seq": length,
            "local_seq": length // world, "steps": args.steps, "losses": losses,
            "step_ms": {"median": statistics.median(ms[1:] or ms), "min": min(ms), "max": max(ms),
                        "first": ms[0]},
            "tokens_per_sec": LONG_ROWS * length / (statistics.median(ms[1:] or ms) / 1e3)}
    if cuda:
        peaks = torch.tensor([(torch.cuda.max_memory_allocated(device) - base) / 1e9], device=device)
        gathered = [torch.zeros_like(peaks) for _ in range(world)]
        dist.all_gather(gathered, peaks)
        line["peak_memory_gb_by_rank"] = [float(v) for v in gathered]
    del state, step, batch
    if cuda:
        torch.cuda.empty_cache()
    if rank == 0:
        with torch.no_grad():
            whole = build().to(device)
            ref, _ = loss_fn(whole, {key: torch.as_tensor(v).to(device) for key, v in host.items()})
        line["loss_one_rank"] = float(ref)
        line["first_loss_rel_gap"] = abs(losses[0] - float(ref)) / abs(float(ref))
        line["tolerance"] = LONG_LOSS_TOL
        del whole, ref
    dist.barrier()
    return line


def _tensors(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return []


def main(argv=None):
    import torch
    import torch.multiprocessing as mp

    parser = argparse.ArgumentParser()
    parser.add_argument("--world", type=int, default=4)
    parser.add_argument("--platform", choices=["gpu", "cpu"], default="gpu")
    parser.add_argument("--size", choices=["full", "small"], default="full")
    parser.add_argument("--steps", type=int, default=5, help="steps a run, and of the loop")
    parser.add_argument("--pairs", type=int, default=5, help="eager/captured timing pairs")
    parser.add_argument("--fsdp", action="store_true",
                        help="add the ZeRO-3 legs: dp=world/2 x fsdp=2 (4+ ranks) and dp=1 x fsdp=world")
    parser.add_argument("--tp", action="store_true",
                        help="add the LM on dp=world/2 x tp=2, tp=world and dp x fsdp=2 x tp=2 (transformer_tp)")
    parser.add_argument("--ep", action="store_true",
                        help="add the 8-expert LM on ep=world and dp=world/2 x ep=2 (transformer_moe)")
    parser.add_argument("--sp", action="store_true",
                        help="add the LM sequence-parallel on sp=world, dp=world/2 x sp=2, tp=2 x sp=world/2 "
                             "and fsdp=2 x sp=world/2 (transformer_sp)")
    parser.add_argument("--sp_long", action="store_true",
                        help="add the long-context leg: sp=world on {} rows of {} tokens".format(
                            LONG_ROWS, LONG_SEQ["full"]))
    parser.add_argument("--models", default="resnet50,transformer",
                        help="comma-separated models of the data-parallel and ZeRO-3 legs ('' for none)")
    parser.add_argument("--dtype", choices=["bfloat16", "float32"], default=None,
                        help="the models' compute dtype; default: bfloat16 on the card, float32 on the CPU")
    args = parser.parse_args(argv)
    args.dtype = args.dtype or ("bfloat16" if args.platform == "gpu" else "float32")
    args.models = [m for m in args.models.split(",") if m] + ["transformer_tp"] * args.tp + \
        ["transformer_moe"] * args.ep + ["transformer_sp"] * args.sp
    if args.platform == "gpu" and torch.cuda.device_count() < args.world:
        raise SystemExit("sync_dp_check: --world {} needs {} CUDA devices, found {}".format(
            args.world, args.world, torch.cuda.device_count()))
    from tensorflowonspark_tpu_torch import util

    port = util.find_free_port("127.0.0.1")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "rank0.json")
        procs = [ctx.Process(target=_rank, args=(r, args.world, port, args, out_path))
                 for r in range(args.world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise SystemExit("sync_dp_check: ranks exited with {}".format(bad))
        with open(out_path) as f:
            lines = json.load(f)
    failed = False
    for line in lines:
        print(json.dumps(line), flush=True)
        if line["model"] == "transformer_sp_long":
            failed |= not line["first_loss_rel_gap"] <= line["tolerance"]
            continue
        failed |= bool(line["loop_vs_eager_mismatches"] or line["tensors_off_rank0"]
                       or len(set(line["losses_by_rank"])) != 1)
        if args.dtype == "float32" and line.get("loss_rel_gap_to_dp", 0) > REL_TOL:
            failed = True
    if failed:
        raise SystemExit("sync_dp_check: a rank, the loop or a ZeRO-3, tp, ep or sp leg disagrees (lines above)")
    return lines


if __name__ == "__main__":
    main()
