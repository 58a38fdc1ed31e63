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
flash kernels), within ``LONG_LOSS_TOL`` relative. ``--sp`` also trains
the LM with 8 experts on ``sp`` = world and ``dp`` = world/2 × ``sp`` = 2
(``transformer_moe_sp``: each rank routes its block of every row, groups
of ``min(256, seq / world)`` tokens) and the LM with ``attention="flash"``
on ``sp`` = world (``transformer_flash_sp``: every rank attends the whole
sequence, gathered), each beside its own data-parallel leg; and the
8-expert LM with groups that span two ``sp`` blocks, which routes the
whole sequence on every rank (the gathered route of ``MoeMlp``): groups of
``2 · seq / world`` on ``sp`` = world (``transformer_moe_sp_span``) and of
a whole row on ``dp`` = world/2 × ``sp`` = 2 (``transformer_moe_dp_sp_span``),
each beside its own data-parallel leg on the same groups.

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
#: the pipeline legs: the LM's depth (2 blocks a stage on pp4), its rows,
#: microbatches, and the float32 gaps to the one-card sequential
#: composition they must keep (loss relative; a stage's gradient as a norm)
PP_LAYERS, PP_ROWS, PP_MICRO, PP_TOL = {"full": 8, "small": 4}, 8, 4, 1e-5
#: the overlap leg: microbatches a rank (of its AXES_ROWS / world rows)
OVERLAP_MICRO = 2


def _lm_cfg(size):
    """The LM's width: ``TransformerConfig``'s defaults at full size."""
    return (dict(vocab_size=32000, d_model=512, n_layers=6, n_heads=8, d_ff=2048) if size == "full"
            else dict(vocab_size=300, d_model=64, n_layers=2, n_heads=2, d_ff=128))


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
    elif model == "transformer_moe_sp":
        legs.append(("moe8_sp{}".format(world), {"dp": 1, "sp": world}, False))
        if half:
            legs.append(("moe8_dp{}_sp2".format(world // 2), {"dp": world // 2, "sp": 2}, False))
    elif model == "transformer_moe_sp_span":
        legs.append(("moe8_sp{}_span".format(world), {"dp": 1, "sp": world}, False))
    elif model == "transformer_moe_dp_sp_span":
        if half:
            legs.append(("moe8_dp{}_sp2_span".format(world // 2), {"dp": world // 2, "sp": 2}, False))
    elif model == "transformer_flash_sp":
        legs.append(("flash_sp{}".format(world), {"dp": 1, "sp": world}, False))
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


def _models(size, device, dtype_name, names, world=1):
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

    lm_cfg = _lm_cfg(size)

    def lm_build(mesh=None, **over):
        return transformer.create_model(mesh=mesh, dtype=dtype_name,
                                        generator=torch.Generator().manual_seed(0),
                                        **dict(dict(lm_cfg, max_seq_len=dims["transformer"]["seq"]), **over))

    # groups of 256 tokens at full size (the JAX default), of a row at the
    # small: a divisor of every rank's token count on every leg
    moe = dict(moe_experts=EXPERTS, moe_group_size=min(256, dims["transformer"]["seq"]))
    # on sp a group that divides every rank's block of the sequence (the
    # local route), and groups of two blocks of sp = world or of sp = 2 (the
    # gathered route)
    moe_sp = dict(moe, moe_group_size=min(256, dims["transformer"]["seq"] // world))
    moe_span = dict(moe, moe_group_size=2 * dims["transformer"]["seq"] // world)
    moe_dp_span = dict(moe, moe_group_size=dims["transformer"]["seq"])

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
        "transformer_moe_sp": (lambda mesh=None: lm_build(mesh, **moe_sp), transformer.make_loss_fn(None),
                               lambda: optim.adamw(3e-4), dict(has_aux=True),
                               lambda rng, world: lm_batch(rng, world, rows)),
        "transformer_moe_sp_span": (lambda mesh=None: lm_build(mesh, **moe_span), transformer.make_loss_fn(None),
                                    lambda: optim.adamw(3e-4), dict(has_aux=True),
                                    lambda rng, world: lm_batch(rng, world, rows)),
        "transformer_moe_dp_sp_span": (lambda mesh=None: lm_build(mesh, **moe_dp_span),
                                       transformer.make_loss_fn(None), lambda: optim.adamw(3e-4),
                                       dict(has_aux=True), lambda rng, world: lm_batch(rng, world, rows)),
        "transformer_flash_sp": (lambda mesh=None: lm_build(mesh, attention="flash"),
                                 transformer.make_loss_fn(None), lambda: optim.adamw(3e-4), dict(has_aux=True),
                                 lambda rng, world: lm_batch(rng, world, rows)),
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

    from tensorflowonspark_tpu_torch.models.transformer import MoeMlp
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
                                                                    args.models, world).items():
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
                # the MoE layers' route on sp: null local, else the real
                # tokens of a row that every rank routes (the gathered route)
                "moe_sp_real": list({m.sp_real for m in loop_state.module.modules()
                                     if isinstance(m, MoeMlp) and m.sp_group is not None}),
                "loop_launches": {key: n for key, n in runs["loop"][2].items() if n},
                "eager_launches": {key: n for key, n in runs["eager"][2].items() if n},
                "step_ms": {side: {"median": statistics.median(w), "min": min(w), "max": max(w)}
                            for side, w in walls.items() if w}}
            if cuda:
                line["peak_memory_gb_by_rank"] = _peaks(device, base, world)
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
    if args.pp:
        results += _pp_legs(rank, world, args, device, sync)
    if args.overlap:
        results.append(_overlap_leg(rank, world, args, device, sync))
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
        line["peak_memory_gb_by_rank"] = _peaks(device, base, world)
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


def pp_stage(cfg, n_blocks):
    """A stage of ``n_blocks`` LM blocks on the ``meta`` device, for
    ``parallel.module_stage``: ``x`` [B, L, d] in, positions 0..L-1 a row
    (one causal segment a row)."""
    import torch

    from tensorflowonspark_tpu_torch.models import transformer

    class Stage(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for j in range(n_blocks):
                self.add_module("b{}".format(j), transformer.Block(cfg))

        def forward(self, x):
            positions = torch.arange(x.shape[1], device=x.device)[None].expand(x.shape[0], x.shape[1])
            for j in range(n_blocks):
                x = getattr(self, "b{}".format(j))(x, positions)
            return x

    with torch.device("meta"):
        return Stage()


def stage_params(model, layers):
    """``{"b<j>.<name>": tensor}`` of the LM's blocks ``layers`` (in the
    stage's order), detached: a :func:`pp_stage`'s parameters."""
    return {"b{}.{}".format(j, n): p.detach() for j, i in enumerate(layers)
            for n, p in getattr(model, "layer_{}".format(i)).named_parameters()}


def _pp_setup(args, device, dtype_name, n_stages):
    """The LM at ``PP_LAYERS`` layers (seed 0) on ``device``, its blocks cut
    into ``n_stages`` stages (``[{"b<j>.<name>": tensor}]``), the stage
    function, the head's loss, and ``PP_ROWS`` rows of ``PP_MICRO``
    microbatches embedded (inputs) with their next tokens (targets)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.parallel import module_stage, split_microbatches

    lm_cfg = _lm_cfg(args.size)
    layers, seq = PP_LAYERS[args.size], (FULL if args.size == "full" else SMALL)["transformer"]["seq"]
    model = transformer.create_model(dtype=dtype_name, generator=torch.Generator().manual_seed(0),
                                     **dict(lm_cfg, n_layers=layers, max_seq_len=seq)).to(device)
    per = layers // n_stages
    stages = [stage_params(model, range(i * per, (i + 1) * per)) for i in range(n_stages)]
    tokens = torch.as_tensor(np.random.default_rng(13).integers(1, lm_cfg["vocab_size"], (PP_ROWS, seq + 1)),
                             device=device)
    with torch.no_grad():
        x = F.embedding(tokens[:, :-1], model.embed.weight).to(model.cfg.compute_dtype)

    def loss_fn(h, t):
        logits = model.lm_head(model.ln_f(h)).float()
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), t.reshape(-1))

    stage_fn = module_stage(pp_stage(model.cfg, per))
    return (model, stages, stage_fn, loss_fn, split_microbatches(x, PP_MICRO),
            split_microbatches(tokens[:, 1:], PP_MICRO))


def _sequential(stage_fn, stages, loss_fn, xs, ts):
    """The stages composed in order under plain autograd on the microbatches:
    the mean loss and every stage's gradients."""
    import torch

    leaves = [{k: v.detach().clone().requires_grad_() for k, v in s.items()} for s in stages]
    loss = 0.0
    for m in range(xs.shape[0]):
        h = xs[m]
        for s in leaves:
            h = stage_fn(s, h)
        loss = loss + loss_fn(h, ts[m]) / xs.shape[0]
    grads = torch.autograd.grad(loss, [t for s in leaves for t in s.values()])
    it = iter(grads)
    return loss.detach(), [{k: next(it) for k in s} for s in leaves]


def _rel_gap(got, want):
    import torch

    flat = lambda tree: torch.cat([t.float().flatten() for t in tree])  # noqa: E731
    return float((flat(got) - flat(want)).norm() / flat(want).norm())


def _timed_ms(fn, sync, steps, barrier=None):
    ms = []
    for _ in range(steps):
        sync()
        if barrier is not None:
            barrier()
        t0 = time.perf_counter()
        fn()
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"median": statistics.median(ms[1:] or ms), "min": min(ms), "max": max(ms), "first": ms[0]}


def _peaks(device, base, world):
    """Every rank's peak memory over ``base`` (GB; collective)."""
    import torch
    import torch.distributed as dist

    peak = torch.tensor([(torch.cuda.max_memory_allocated(device) - base) / 1e9], device=device)
    gathered = [torch.zeros_like(peak) for _ in range(world)]
    dist.all_gather(gathered, peak)
    return [float(v) for v in gathered]


def _pp_legs(rank, world, args, device, sync):
    """GPipe over NCCL (``pipeline_apply``) on ``pp`` = world and ``dp`` =
    world/2 × ``pp`` = 2 (``batch_axis="dp"``), the LM at ``PP_LAYERS``
    layers: in float32 the loss and this rank's stage gradient against the
    one-card sequential composition (gaps gathered), in bfloat16 the step
    ms and each rank's peak memory; then on rank 0 ``Pipeline1F1B`` with
    its stages on the ``world`` cards (``cuda:0..``; the CPU ``world``
    times at ``--platform cpu``)."""
    import torch
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.parallel import build_mesh, collectives, pipeline_apply, stack_stage_params

    cuda = device.type == "cuda"
    legs = [("pp{}".format(world), {"pp": world}, None)]
    if world >= 4 and world % 2 == 0:
        legs.append(("dp{}_pp2".format(world // 2), {"dp": world // 2, "pp": 2}, "dp"))
    lines = []
    for leg, axes, batch_axis in legs:
        mesh = build_mesh(axes)
        stage = collectives.axis_index("pp", mesh)
        line = {"model": "transformer_pp", "leg": leg, "world": world, "platform": args.platform,
                "size": args.size, "layers": PP_LAYERS[args.size], "stages": axes["pp"], "rows": PP_ROWS,
                "microbatches": PP_MICRO, "mesh": axes, "batch_axis": batch_axis}
        for dtype_name in ("float32", "bfloat16"):
            model, stages, stage_fn, loss_fn, xs, ts = _pp_setup(args, device, dtype_name, axes["pp"])
            stacked = {k: v.clone().requires_grad_() for k, v in stack_stage_params(stages).items()}

            def step():
                out = pipeline_apply(stage_fn, stacked, xs, mesh, batch_axis=batch_axis)
                loss = sum(loss_fn(out[m], ts[m]) for m in range(PP_MICRO)) / PP_MICRO
                return loss.detach(), torch.autograd.grad(loss, list(stacked.values()))

            if dtype_name == "float32":
                loss, grads = step()
                ref_loss, ref_grads = _sequential(stage_fn, stages, loss_fn, xs, ts)
                gaps = torch.tensor([abs(float(loss) - float(ref_loss)) / abs(float(ref_loss)),
                                     _rel_gap([g[stage] for g in grads], list(ref_grads[stage].values()))],
                                    device=device)
                every = [torch.zeros_like(gaps) for _ in range(world)]
                dist.all_gather(every, gaps)
                line["f32_loss"], line["f32_loss_sequential"] = float(loss), float(ref_loss)
                line["f32_loss_rel_gap"] = max(float(g[0]) for g in every)
                line["f32_grad_rel_gap_by_rank"] = [float(g[1]) for g in every]
                del grads, ref_grads
            else:
                if cuda:
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats(device)
                    base = torch.cuda.memory_allocated(device)
                line["bf16_step_ms"] = _timed_ms(step, sync, args.steps, dist.barrier)
                if cuda:
                    line["peak_memory_gb_by_rank"] = _peaks(device, base, world)
            del model, stages, stacked, xs, ts
            if cuda:
                torch.cuda.empty_cache()
        lines.append(line)
    dist.barrier()
    if rank == 0:
        lines.append(_one_f1b(args, world, sync))
    dist.barrier()
    return lines


def _one_f1b(args, world, sync):
    """``Pipeline1F1B`` in this process with one stage a card (the CPU
    ``world`` times at ``--platform cpu``): float32 gaps to the one-card
    sequential composition, bfloat16 step ms with overlap on and off, each
    card's peak memory, the measured bubble and overlap fractions."""
    import torch

    from tensorflowonspark_tpu_torch.parallel import Pipeline1F1B

    cuda = args.platform == "gpu"
    devices = [torch.device("cuda", i) if cuda else torch.device("cpu") for i in range(world)]
    sync_all = (lambda: [torch.cuda.synchronize(d) for d in devices]) if cuda else sync
    line = {"model": "transformer_pp", "leg": "1f1b_{}_cards".format(world), "world": world,
            "platform": args.platform, "size": args.size, "layers": PP_LAYERS[args.size], "stages": world,
            "rows": PP_ROWS, "microbatches": PP_MICRO, "devices": [str(d) for d in devices]}
    for dtype_name in ("float32", "bfloat16"):
        model, stages, stage_fn, loss_fn, xs, ts = _pp_setup(args, devices[0], dtype_name, world)
        # the head closes the last stage on its card
        head = _Head(model).to(devices[-1])
        pipes = {side: Pipeline1F1B(stage_fn, stages, head, devices=devices, overlap=side == "on")
                 for side in ("on", "off")}
        try:
            if dtype_name == "float32":
                loss, grads = pipes["on"].step(xs, ts)
                ref_loss, ref_grads = _sequential(stage_fn, stages, loss_fn, xs, ts)
                line["f32_loss_rel_gap"] = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
                line["f32_grad_rel_gap_by_stage"] = [
                    _rel_gap([g[k].to(devices[0]) for k in g], list(r.values())) for g, r in zip(grads, ref_grads)]
                off_loss, off_grads = pipes["off"].step(xs, ts)
                line["f32_on_off_bitwise"] = bool(torch.equal(loss, off_loss) and all(
                    torch.equal(a[k], b[k]) for a, b in zip(grads, off_grads) for k in a))
                del grads, ref_grads, off_grads
            else:
                if cuda:
                    for d in devices:
                        torch.cuda.reset_peak_memory_stats(d)
                line["bf16_step_ms"] = {side: _timed_ms(lambda p=p: p.step(xs, ts), sync_all, args.steps)
                                        for side, p in pipes.items()}
                line["bubble_fraction"] = {side: p.last_stats["bubble_fraction"] for side, p in pipes.items()}
                line["bubble_fraction_closed_form"] = pipes["on"].last_stats["bubble_fraction_theory"]
                line["overlap_fraction"] = {side: p.last_stats["overlap_fraction"] for side, p in pipes.items()}
                line["transfer_ms"] = {side: p.last_stats["comm_busy_s"] * 1e3 for side, p in pipes.items()}
                if cuda:
                    line["peak_memory_gb_by_card"] = [torch.cuda.max_memory_allocated(d) / 1e9 for d in devices]
        finally:
            for p in pipes.values():
                p.close()
        del model, stages, pipes, head
        if cuda:
            torch.cuda.empty_cache()
    return line


class _Head:
    """The LM's final norm, head and cross-entropy as a ``loss_fn(h, t)``
    on the last stage's card."""

    def __init__(self, model):
        self.ln_f, self.lm_head = model.ln_f, model.lm_head

    def to(self, device):
        import copy

        head = copy.copy(self)
        head.ln_f, head.lm_head = copy.deepcopy(self.ln_f).to(device), copy.deepcopy(self.lm_head).to(device)
        return head

    def __call__(self, h, t):
        import torch.nn.functional as F

        logits = self.lm_head(self.ln_f(h)).float()
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), t.reshape(-1))


def _overlap_leg(rank, world, args, device, sync):
    """``BucketedOverlap`` of the full-width LM over ``world`` processes
    through a ``HostAllReduceGroup`` bootstrapped over the world: each rank
    on ``OVERLAP_MICRO`` microbatches of its rows of a global batch of
    ``AXES_ROWS`` rows (at least a row a microbatch), ``args.steps`` AdamW steps with overlap on and off
    from the same weights. Losses by rank and side, step ms (host clock, a
    sync after each step), the comm thread's seconds, buckets, overlap
    fraction, peak memory."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.parallel import HostAllReduceGroup
    from tensorflowonspark_tpu_torch.train import BucketedOverlap, SyncDataParallel

    build, loss_fn, make_opt, kw, make_batch = _models(args.size, device, args.dtype, ["transformer"])[
        "transformer"]
    glob = make_batch(np.random.default_rng(11), world, max(AXES_ROWS[args.size], OVERLAP_MICRO * world))
    n = next(iter(glob.values())).shape[0] // world
    mine = {k: v[rank * n:(rank + 1) * n] for k, v in glob.items()}
    per = n // OVERLAP_MICRO
    strategy = SyncDataParallel(device)
    mbs = [strategy.shard_batch({k: v[j * per:(j + 1) * per] for k, v in mine.items()})
           for j in range(OVERLAP_MICRO)]
    cuda = device.type == "cuda"
    line = {"model": "transformer_overlap", "leg": "dp{}_host_group".format(world), "world": world,
            "platform": args.platform, "size": args.size, "dtype": args.dtype, "steps": args.steps,
            "rows_per_rank": n, "microbatches": OVERLAP_MICRO}
    with HostAllReduceGroup(rank, world) as group:
        for side in ("on", "off"):
            optimizer = make_opt()
            state = strategy.create_state(build, optimizer)
            sched = BucketedOverlap(strategy, loss_fn, optimizer, group=group, overlap=side == "on", **kw)
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
            losses, ms = [], []
            for _ in range(args.steps):
                sync()
                t0 = time.perf_counter()
                state, metrics = sched.step(state, mbs)
                losses.append(float(metrics["loss"]))
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
            stats = dict(sched.last_stats)
            sched.close()
            every = [None] * world
            dist.all_gather_object(every, losses)
            line["losses_by_rank_" + side] = every
            line["step_ms_" + side] = {"median": statistics.median(ms[1:] or ms), "min": min(ms), "max": max(ms)}
            line["comm_busy_s_" + side] = stats["comm_busy_s"]
            line["device_wait_s_" + side] = stats["device_wait_s"]
            line["overlap_fraction_" + side] = stats["overlap_fraction"]
            line["buckets"] = stats["buckets"]
            if cuda:
                line["peak_memory_gb_by_rank_" + side] = _peaks(device, 0, world)
            del state, sched, optimizer
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
                             "and fsdp=2 x sp=world/2 (transformer_sp), the 8-expert LM on sp=world and "
                             "dp=world/2 x sp=2 (transformer_moe_sp), flash attention over the whole "
                             "sequence on sp=world (transformer_flash_sp) and the 8-expert LM with groups "
                             "spanning two sp blocks on sp=world and dp=world/2 x sp=2 "
                             "(transformer_moe_sp_span, transformer_moe_dp_sp_span)")
    parser.add_argument("--sp_long", action="store_true",
                        help="add the long-context leg: sp=world on {} rows of {} tokens".format(
                            LONG_ROWS, LONG_SEQ["full"]))
    parser.add_argument("--pp", action="store_true",
                        help="add GPipe (pipeline_apply over NCCL) on pp=world and dp=world/2 x pp=2, and "
                             "Pipeline1F1B with a stage a card, the LM at {} layers".format(PP_LAYERS["full"]))
    parser.add_argument("--overlap", action="store_true",
                        help="add BucketedOverlap of the LM over a HostAllReduceGroup of the ranks")
    parser.add_argument("--models", default="resnet50,transformer",
                        help="comma-separated models of the data-parallel and ZeRO-3 legs ('' for none)")
    parser.add_argument("--dtype", choices=["bfloat16", "float32"], default=None,
                        help="the models' compute dtype; default: bfloat16 on the card, float32 on the CPU")
    args = parser.parse_args(argv)
    args.dtype = args.dtype or ("bfloat16" if args.platform == "gpu" else "float32")
    args.models = [m for m in args.models.split(",") if m] + ["transformer_tp"] * args.tp + \
        ["transformer_moe"] * args.ep + ["transformer_sp", "transformer_moe_sp", "transformer_flash_sp",
                                         "transformer_moe_sp_span", "transformer_moe_dp_sp_span"] * args.sp
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
        if line["model"] == "transformer_pp":
            gaps = line.get("f32_grad_rel_gap_by_rank") or line.get("f32_grad_rel_gap_by_stage")
            failed |= not (line["f32_loss_rel_gap"] <= PP_TOL and max(gaps) <= PP_TOL
                           and line.get("f32_on_off_bitwise", True))
            continue
        if line["model"] == "transformer_overlap":
            on, off = line["losses_by_rank_on"], line["losses_by_rank_off"]
            failed |= not (all(r == on[0] for r in on) and on == off and on[0][-1] < on[0][0])
            continue
        failed |= bool(line["loop_vs_eager_mismatches"] or line["tensors_off_rank0"]
                       or len(set(line["losses_by_rank"])) != 1)
        if line["leg"].endswith("_span"):  # its groups cross sp blocks: the gathered route
            failed |= not line["moe_sp_real"] or None in line["moe_sp_real"]
        if args.dtype == "float32" and line.get("loss_rel_gap_to_dp", 0) > REL_TOL:
            failed = True
    if failed:
        raise SystemExit("sync_dp_check: a rank, the loop or a ZeRO-3, tp, ep, sp, pp or overlap leg disagrees "
                         "(lines above)")
    return lines


if __name__ == "__main__":
    main()
