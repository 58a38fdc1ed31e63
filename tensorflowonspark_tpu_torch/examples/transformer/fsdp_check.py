"""Fully sharded LM training (ZeRO-3) checked bitwise against data
parallelism, through ``TFCluster.run``, then resharded from a checkpoint.

The trainer (:func:`main_fun`, one executor) builds two strategies on the
cluster's world of one rank: ``SyncDataParallel(ctx.mesh({"dp": 1, "fsdp":
-1}), fsdp=True)`` and the data-parallel ``SyncDataParallel(ctx.mesh({"dp":
-1}))``. On each, from the same seed-0 weights and the same packed text
batches, it trains the transformer LM for ``--eager_steps`` eager steps and
two calls of the captured train loop (K = ``--steps_per_loop``; on the card
call 1 warms up and captures, call 2 is traced with ``torch.profiler``), and
keeps the flash wrappers' launches, the traced call's device launches and
the peak memory; then ``--pairs`` turns time an eager step and a loop call
on each side in turn (the step ms are their medians). With one rank every gather, reduce-scatter and all-reduce of the
sharded step moves the bytes as they are, so the two runs must agree
**bitwise**: parameters and loss after the eager steps and after the loop.
Then the sharded state is saved, restored onto a fresh data-parallel state
with ``ckpt.reshard_restore``, and both take one more step: again bitwise.

Usage (one H100, the LM at ``TransformerConfig``'s full width: vocab 32000,
d_model 512, 6 layers, 8 heads, d_ff 2048, seq 2048, batch 8, bf16; f32 on
the CPU)::

    python -m tensorflowonspark_tpu_torch.examples.transformer.fsdp_check

and a rehearsal on the CPU at a small size::

    python -m tensorflowonspark_tpu_torch.examples.transformer.fsdp_check \\
        --platform cpu --size small

The trainer writes its readings as JSON to ``<work_dir>/fsdp_check.json``;
:func:`main` returns them (the command line prints them) and exits non-zero
on any disagreement.
"""

import argparse
import json
import os
import statistics
import tempfile
import time

FULL = dict(vocab_size=32000, d_model=512, n_layers=6, n_heads=8, d_ff=2048, seq_len=2048, batch=8)
SMALL = dict(vocab_size=300, d_model=64, n_layers=2, n_heads=4, d_ff=128, seq_len=64, batch=2)


def _snapshot(state):
    return {k: v.detach().clone() for k, v in dict(state.params, **state.model_state).items()}


def _mismatches(a, b):
    import torch

    return sorted(k for k in a if not torch.equal(a[k], b[k]))


def _eager(run, sync):
    """One eager step of a side on its next batch, timed."""
    sync()
    t0 = time.perf_counter()
    run["state"], metrics = run["step"](run["state"], next(run["batches"]))
    sync()
    run["eager_ms"].append((time.perf_counter() - t0) * 1e3)
    run["losses"].append(metrics["loss"].clone())


def _call(run, k, sync):
    """One call of a side's train loop on its next K batches, timed."""
    window = [next(run["batches"]) for _ in range(k)]
    sync()
    t0 = time.perf_counter()
    run["state"], metrics = run["loop"](run["state"], window)
    sync()
    run["call_ms"].append((time.perf_counter() - t0) * 1e3)
    run["losses"].append(metrics["loss"].clone())


def main_fun(args, ctx):
    import torch

    from tensorflowonspark_tpu_torch import ckpt
    from tensorflowonspark_tpu_torch import tfrecord as tfr
    from tensorflowonspark_tpu_torch.data import TextPipeline, Tokenizer
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.ops import flash_attention
    from tensorflowonspark_tpu_torch.ops.kernel_trace import KernelTrace
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, checkpoint, optim

    size = FULL if args.size == "full" else SMALL
    dtype = "bfloat16" if args.platform == "gpu" else "float32"
    cfg = {k: v for k, v in size.items() if k not in ("seq_len", "batch")}
    e, k = args.eager_steps, args.steps_per_loop
    stream = iter(TextPipeline(tfr.list_shards(args.data_dir), Tokenizer(kind="byte"),
                               seq_len=size["seq_len"] + 1, batch_size=size["batch"], seed=0,
                               epochs=None, pack_workers=0))
    host = [next(stream) for _ in range(e + 2 * k + args.pairs * (1 + k) + 1)]
    stream.close()
    if ctx.num_processes != 1:
        raise ValueError("fsdp_check runs on one rank (the bitwise comparison needs a world of one)")
    device = ctx.device
    cuda = device.type == "cuda"
    sides = {"fsdp": SyncDataParallel(ctx.mesh({"dp": 1, "fsdp": -1}), fsdp=True),
             "dp": SyncDataParallel(ctx.mesh({"dp": -1}))}

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def build(strategy, seed):
        model = transformer.create_model(dtype=dtype, max_seq_len=size["seq_len"], **cfg)
        optimizer = optim.adamw(3e-4)
        state = strategy.create_state(transformer.make_init_fn(model), optimizer,
                                      torch.Generator().manual_seed(seed))
        loss_fn = transformer.make_loss_fn(model)
        return state, strategy.compile_train_step(loss_fn, optimizer, has_aux=True), \
            strategy.compile_train_loop(loss_fn, optimizer, k, has_aux=True)

    out = {"size": args.size, "config": size, "dtype": dtype, "eager_steps": e, "steps_per_loop": k,
           "timed_pairs": args.pairs, "device": str(device)}
    runs = {}
    for name, strategy in sides.items():
        if cuda:
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        flash_attention.reset_launch_counts()
        state, step, loop = build(strategy, 0)
        run = {"state": state, "step": step, "loop": loop, "losses": [], "eager_ms": [], "call_ms": [],
               "batches": iter([strategy.shard_batch(b) for b in host])}
        for _ in range(e):
            _eager(run, sync)
        run["after_eager"] = _snapshot(run["state"])
        _call(run, k, sync)  # the loop's warm-up steps and capture
        with KernelTrace() as traced:
            _call(run, k, sync)
        opt = run["state"].opt_state
        out[name] = {
            "launches": flash_attention.launch_counts(),
            "device_launches_traced_call": traced.readings["launches"],
            "graph_launches_traced_call": traced.readings["graph_launches"],
            "idle_share_traced_call": traced.readings["idle_share"],
            "adam_state_bytes": sum(t.numel() * t.element_size() for t in list(opt["mu"].values())
                                    + list(opt["nu"].values())),
            "params_sharded": len(state.sharded.dims) if state.sharded is not None else 0,
            "params": len(state.params),
        }
        if cuda:
            out[name]["peak_memory_gb"] = (torch.cuda.max_memory_allocated(device) - base) / 1e9
        run["eager_ms"], run["call_ms"] = run["eager_ms"][1:], []  # the first step built the kernels
        runs[name] = run
        del state, step, loop
    for _ in range(args.pairs):  # timed in turns: an eager step and a loop call a side
        for run in runs.values():
            _eager(run, sync)
            _call(run, k, sync)
    tokens = size["batch"] * size["seq_len"]
    for name, run in runs.items():
        captured = [ms / k for ms in run["call_ms"]]
        out[name].update(
            losses=[float(v) for v in run["losses"]],
            eager_step_ms={"median": statistics.median(run["eager_ms"]), "min": min(run["eager_ms"]),
                           "max": max(run["eager_ms"])},
            captured_step_ms={"median": statistics.median(captured), "min": min(captured), "max": max(captured)},
            tokens_per_sec_captured=tokens / (statistics.median(captured) / 1e3))
    fsdp, dp = runs["fsdp"], runs["dp"]
    out["eager_mismatches"] = _mismatches(fsdp["after_eager"], dp["after_eager"])
    out["loop_mismatches"] = _mismatches(_snapshot(fsdp["state"]), _snapshot(dp["state"]))
    out["losses_bitwise"] = bool(torch.equal(torch.stack(fsdp["losses"]), torch.stack(dp["losses"])))
    del runs, dp

    # save the sharded state, reshard it onto a fresh data-parallel state
    # (other initial weights), and take one more step on both
    path = os.path.join(args.work_dir, "ckpt_fsdp_{}".format(fsdp["state"].step))
    t0 = time.perf_counter()
    checkpoint.save_checkpoint(path, fsdp["state"])
    out["save_s"] = time.perf_counter() - t0
    fresh, dp_step, _ = build(sides["dp"], 1)
    t0 = time.perf_counter()
    restored = ckpt.reshard_restore(path, strategy=sides["dp"], target=fresh)
    sync()
    out["restore_s"] = time.perf_counter() - t0
    out["restored_mismatches"] = _mismatches(_snapshot(restored), _snapshot(fsdp["state"]))
    out["restored_step"] = restored.step
    last = sides["dp"].shard_batch(host[-1])
    state, metrics = fsdp["step"](fsdp["state"], last)
    restored, restored_metrics = dp_step(restored, last)
    out["resumed_mismatches"] = _mismatches(_snapshot(restored), _snapshot(state))
    out["resumed_loss_bitwise"] = bool(torch.equal(metrics["loss"], restored_metrics["loss"]))
    out["resumed_step"] = restored.step
    with open(os.path.join(args.work_dir, "fsdp_check.json"), "w") as f:
        json.dump(out, f)


def failures(out):
    """What in the trainer's readings breaks the contract (empty: none)."""
    bad = [key for key in ("eager_mismatches", "loop_mismatches", "restored_mismatches", "resumed_mismatches")
           if out[key]]
    bad += [key for key in ("losses_bitwise", "resumed_loss_bitwise") if not out[key]]
    if out["fsdp"]["params_sharded"] == 0:
        bad.append("no parameter sharded")
    return bad


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--platform", choices=["gpu", "cpu"], default="gpu")
    parser.add_argument("--size", choices=["full", "small"], default="full")
    parser.add_argument("--eager_steps", type=int, default=5)
    parser.add_argument("--steps_per_loop", type=int, default=5)
    parser.add_argument("--pairs", type=int, default=5,
                        help="timed turns: an eager step and a loop call on each side")
    parser.add_argument("--data_dir", default=None, help="TFRecord text shards; default: the LM example's "
                                                          "synthetic corpus")
    parser.add_argument("--work_dir", default=None, help="checkpoint and readings; default: a temporary dir")
    return parser


def main(argv=None, sc=None):
    """Run the check on one executor; returns the trainer's readings and
    raises ``SystemExit`` when they break the contract."""
    from tensorflowonspark_tpu_torch import TFCluster, util
    from tensorflowonspark_tpu_torch.backends import get_spark_context
    from tensorflowonspark_tpu_torch.examples.transformer import transformer_spark

    args = build_parser().parse_args(argv)
    if not args.data_dir:
        args.data_dir = os.path.join(tempfile.gettempdir(), "tos_transformer_corpus")
        transformer_spark.make_text_corpus(args.data_dir)
    with tempfile.TemporaryDirectory() as tmp:
        args.work_dir = args.work_dir or tmp
        os.makedirs(args.work_dir, exist_ok=True)
        sc, _, owned = get_spark_context("fsdp_check", 1, sc=sc, local_default=1)
        try:
            cluster = TFCluster.run(sc, main_fun, args, 1, input_mode=TFCluster.InputMode.TENSORFLOW,
                                    master_node="chief", env={util.ENV_PLATFORM: args.platform})
            cluster.shutdown()
        finally:
            if owned:
                sc.stop()
        with open(os.path.join(args.work_dir, "fsdp_check.json")) as f:
            out = json.load(f)
    bad = failures(out)
    if bad:
        raise SystemExit("fsdp_check: the sharded run disagrees with data parallelism: {}".format(bad))
    return out


if __name__ == "__main__":
    from tensorflowonspark_tpu_torch import util

    util.setup_logging()
    print(json.dumps(main()), flush=True)
