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

Usage (four cards of one host, full ResNet-50 and the full-width LM)::

    python -m tensorflowonspark_tpu_torch.examples.sync_dp_check --world 4

and a rehearsal on the CPU at a small size::

    python -m tensorflowonspark_tpu_torch.examples.sync_dp_check --platform cpu \\
        --world 4 --size small --steps 3 --pairs 0
"""

import argparse
import json
import os
import statistics
import tempfile
import time

#: full size: the two slices' models and per-card batches
FULL = {"resnet50": dict(batch=64, image=224), "transformer": dict(batch=8, seq=2048)}
SMALL = {"resnet50": dict(batch=4, image=32), "transformer": dict(batch=2, seq=64)}


def _models(size, device):
    """``{name: (build, loss_fn, optimizer factory, loop kwargs, global
    batch maker)}`` for the slices' two models."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.models import resnet, transformer
    from tensorflowonspark_tpu_torch.train import optim

    dims = FULL if size == "full" else SMALL
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32

    def resnet_build():
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

    def lm_build():
        return transformer.create_model(dtype="bfloat16" if device.type == "cuda" else "float32",
                                        max_seq_len=dims["transformer"]["seq"],
                                        generator=torch.Generator().manual_seed(0), **lm_cfg)

    def lm_batch(rng, world):
        n, length = dims["transformer"]["batch"] * world, dims["transformer"]["seq"] + 1
        tokens = rng.integers(1, lm_cfg["vocab_size"], (n, length)).astype(np.int32)
        cut = length // 3
        seg = np.where(np.arange(length) < cut, 1, 2)[None].repeat(n, 0).astype(np.int32)
        pos = np.concatenate([np.arange(cut), np.arange(length - cut)])[None].repeat(n, 0).astype(np.int32)
        return {"tokens": tokens, "segment_ids": seg, "positions": pos}

    return {
        "resnet50": (resnet_build, resnet.make_loss_fn(weight_decay=1e-4),
                     lambda: optim.sgd(optim.linear_schedule(0.0, 0.1, 5), momentum=0.9),
                     dict(mutable=True), resnet_batch),
        "transformer": (lm_build, transformer.make_loss_fn(None), lambda: optim.adamw(3e-4),
                        dict(has_aux=True), lm_batch),
    }


def _rank(rank, world, port, args, out_path):
    import numpy as np
    import torch
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.ops import flash_attention, fused_bn
    from tensorflowonspark_tpu_torch.train import SyncDataParallel

    cuda = args.platform == "gpu"
    if cuda:
        torch.cuda.set_device(rank)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo", init_method="tcp://127.0.0.1:{}".format(port),
                            rank=rank, world_size=world)
    strategy = SyncDataParallel(device)
    k = args.steps

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def counts():
        return {fn.__name__: fn.launches for fn in fused_bn.COUNTED + flash_attention.KERNELS}

    results = []
    for name, (build, loss_fn, make_opt, kw, make_batch) in _models(args.size, device).items():
        rng = np.random.default_rng(11)
        share = []
        for _ in range(k):
            batch = make_batch(rng, world)
            n = next(iter(batch.values())).shape[0] // world
            share.append(strategy.shard_batch({key: v[rank * n:(rank + 1) * n] for key, v in batch.items()}))
        runs = {}
        for side in ("eager", "loop"):
            optimizer = make_opt()
            state = strategy.create_state(build, optimizer)
            before = counts()
            if side == "eager":
                step = strategy.compile_train_step(loss_fn, optimizer, **kw)
                for b in share:
                    state, metrics = step(state, b)
            else:
                loop = strategy.compile_train_loop(loss_fn, optimizer, k, **kw)
                state, metrics = loop(state, share)
            sync()
            launches = {key: n - before[key] for key, n in counts().items()}
            snap = {key: v.detach().clone() for key, v in dict(state.params, **state.model_state).items()}
            runs[side] = (snap, metrics["loss"].detach().reshape(1).clone(), launches)
            if side == "eager":
                timer = (step, state)
            else:
                timed = (loop, state)
        mismatched = [key for key, v in runs["eager"][0].items() if not torch.equal(v, runs["loop"][0][key])]
        if not torch.equal(runs["eager"][1], runs["loop"][1]):
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
        results.append({
            "model": name, "world": world, "platform": args.platform, "size": args.size, "steps": k,
            "batch_per_rank": next(iter(share[0].values())).shape[0],
            "losses_by_rank": [float(v) for v in losses], "loop_vs_eager_mismatches": mismatched,
            "tensors": len(runs["loop"][0]), "tensors_off_rank0": off_rank0,
            "loop_launches": {key: n for key, n in runs["loop"][2].items() if n},
            "eager_launches": {key: n for key, n in runs["eager"][2].items() if n},
            "step_ms": {side: {"median": statistics.median(w), "min": min(w), "max": max(w)}
                        for side, w in walls.items() if w}})
        del runs, timer, timed, step, loop, eager_state, loop_state, share
        if cuda:
            torch.cuda.empty_cache()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None):
    import torch
    import torch.multiprocessing as mp

    parser = argparse.ArgumentParser()
    parser.add_argument("--world", type=int, default=4)
    parser.add_argument("--platform", choices=["gpu", "cpu"], default="gpu")
    parser.add_argument("--size", choices=["full", "small"], default="full")
    parser.add_argument("--steps", type=int, default=5, help="steps a run, and of the loop")
    parser.add_argument("--pairs", type=int, default=5, help="eager/captured timing pairs")
    args = parser.parse_args(argv)
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
        failed |= bool(line["loop_vs_eager_mismatches"] or line["tensors_off_rank0"]
                       or len(set(line["losses_by_rank"])) != 1)
    if failed:
        raise SystemExit("sync_dp_check: a rank or the loop disagrees (lines above)")


if __name__ == "__main__":
    main()
