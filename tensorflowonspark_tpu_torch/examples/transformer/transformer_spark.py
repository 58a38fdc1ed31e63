"""Transformer LM training on a cluster — the port of
``examples/transformer/transformer_spark.py``.

Real packed text: TFRecord text shards (without ``--data_dir``, a
deterministic synthetic corpus made on the driver) stream through the
port's :class:`~tensorflowonspark_tpu_torch.data.TextPipeline`, which
tokenizes and FFD-packs records into ``[B, seq_len + 1]`` rows with
``segment_ids`` and ``positions``, so every attention call runs causal with
the segment fence. Each node's trainer child runs on ``--platform``
(default ``gpu``: one CUDA device per process; ``gpu`` without a CUDA device
raises), where ``attention="auto"`` runs the port's flash-attention CUDA
kernels. The optimizer is ``optax.adamw(--learning_rate)``'s counterpart.

Usage (one executor, one H100; the model's full width)::

    python -m tensorflowonspark_tpu_torch.examples.transformer.transformer_spark \\
        --vocab_size 32000 --d_model 512 --n_layers 6 --n_heads 8 --d_ff 2048 \\
        --seq_len 2048 --batch_size 8 --dtype bfloat16 --tokenizer byte \\
        --train_steps 5 --log_steps 1

The kernels take head dims 64 and 128 (``d_model / n_heads``).
``--steps_per_loop K`` runs K steps a call through
``SyncDataParallel.compile_train_loop``, as the JAX example does: on the
card the step is captured once in a CUDA graph and replayed (the first two
steps run eagerly as its warm-up). Batches are placed ahead through pinned
buffers (``loop_prefetch`` windows for the loop, ``device_prefetch`` for
the eager step); each call's successor is fetched after the call is queued
and before its loss is read, so the host packs and places the next
batches while the card trains. Each logged step (or loop of K steps) lands
in the node's obs registry as a ``train_step`` span (its last step, the
steps it ran, loss, tokens/s) and the kernel wrappers' launches as
``flash_attention_<kernel>_launches_total`` counters (eager launches and
launches into a captured graph), so the Spark driver reads them from
``cluster.metrics()``. ``--trace_call N`` traces the N-th call with
``torch.profiler`` (``ops/kernel_trace.KernelTrace``): the device kernels
of each wrapper, graph launches, device busy ms and idle share, and the
host ms in ``train.fetch`` / ``train.call`` / ``train.sync`` (and
``loader.place``, the placement within the fetch), printed and
set on that call's span as ``device_trace``.

With ``--model_dir`` a run resumes from the newest restorable checkpoint
there (``checkpoint.restore_latest``, in place) and rank 0 saves the final
state as ``ckpt_<train_steps>``, as the JAX example does; the text stream
starts over on resume.

Not yet ported, and refused with an error: ``--moe_experts`` > 0,
``--mesh`` axes other than ``dp`` (tensor and sequence parallelism, ring
attention), ``--remat``, ``--slab_cache_dir`` (the packed-slab cache) and
``--pack_workers`` > 0 (the forked pack plane: the trainer child has CUDA up
by the time the pipeline starts, and a process must not fork after that).
"""

import argparse
import os
import tempfile

#: word list for the synthetic corpus — varied lengths so FFD has real work
_WORDS = (
    "the spark cluster streams tokenized text through shared memory slabs "
    "while accelerator meshes consume packed sequences of variable length "
    "records a distributed pipeline keeps every chip busy with deterministic "
    "batches and observability counters tracking efficiency"
).split()


def make_text_corpus(data_dir, num_shards=4, records_per_shard=512, seed=0):
    """Materialize a deterministic synthetic text corpus as TFRecord shards
    (raw UTF-8 records, the ``Tokenizer(field=None)`` shape). Record lengths
    are lognormal-ish so sequence packing has a realistic distribution to
    chew on. Idempotent: existing shards are reused."""
    import numpy as np

    from tensorflowonspark_tpu_torch import tfrecord as tfr

    existing = tfr.list_shards(data_dir) if os.path.isdir(data_dir) else []
    if len(existing) >= num_shards:
        return existing
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for s in range(num_shards):
        path = os.path.join(data_dir, "part-{:05d}".format(s))
        with tfr.TFRecordWriter(path) as w:
            for _ in range(records_per_shard):
                n = max(3, int(rng.lognormal(mean=3.0, sigma=0.6)))
                text = " ".join(rng.choice(_WORDS, size=n))
                w.write(text.encode("utf-8"))
    return tfr.list_shards(data_dir)


def parse_mesh(spec):
    """'dp=2,tp=2,sp=2' → {'dp': 2, 'tp': 2, 'sp': 2} (None: all-dp)."""
    if not spec:
        return None
    axes = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        axes[name.strip()] = int(size)
    return axes


def refuse_unported(args):
    """Raise for the options whose machinery is not yet ported."""
    model_axes = sorted(set(parse_mesh(args.mesh) or {}) - {"dp"})
    unported = [
        ("--moe_experts", args.moe_experts > 0, "mixture of experts"),
        ("--mesh " + ",".join(model_axes), model_axes, "model axes (tp/sp/ep, ring attention)"),
        ("--remat", args.remat, "rematerialization"),
        ("--pack_workers", (args.pack_workers or 0) > 0,
         "a pack plane built before the trainer touches CUDA"),
        ("--slab_cache_dir", args.slab_cache_dir, "the packed-slab cache"),
    ]
    for flag, value, what in unported:
        if value:
            raise NotImplementedError(
                "{} is not yet ported to tensorflowonspark_tpu_torch ({} comes in a "
                "later slice)".format(flag, what)
            )


def main_fun(args, ctx):
    import contextlib
    import json
    import time

    import torch
    from torch.autograd.profiler import record_function

    from tensorflowonspark_tpu_torch import obs
    from tensorflowonspark_tpu_torch import tfrecord as tfr
    from tensorflowonspark_tpu_torch.data import (TextPipeline, Tokenizer, device_prefetch, loop_prefetch,
                                                  shard_files)
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.ops import flash_attention
    from tensorflowonspark_tpu_torch.ops.kernel_trace import KernelTrace
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, checkpoint, optim

    refuse_unported(args)
    ctx.initialize_distributed()
    strategy = SyncDataParallel(ctx.device)
    model = transformer.create_model(
        vocab_size=args.vocab_size, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads, d_ff=args.d_ff,
        max_seq_len=args.seq_len, dtype=args.dtype,
    )
    optimizer = optim.adamw(args.learning_rate)
    state = strategy.create_state(
        transformer.make_init_fn(model), optimizer, torch.Generator().manual_seed(0)
    )
    loss_fn = transformer.make_loss_fn(model)
    start_step = 0
    if args.model_dir:
        # resume contract (run_with_recovery / job resubmission): continue
        # from the newest restorable checkpoint, copied into the state in place
        with obs.span("ckpt_restore") as sp:
            _, latest = checkpoint.restore_latest(args.model_dir, target=state)
            sp.set(path=latest, step=state.step)
        if latest:
            start_step = state.step
            print("resuming from {} at step {}".format(latest, start_step))
    step = strategy.compile_train_step(loss_fn, optimizer, has_aux=True)
    steps_per_loop = max(args.steps_per_loop or 1, 1)
    loop = None
    if steps_per_loop > 1:
        # K steps a call: on the card one captured CUDA graph, replayed
        loop = strategy.compile_train_loop(loss_fn, optimizer, steps_per_loop, has_aux=True)

    # real corpus: per-worker TFRecord text shards → tokenize → FFD-pack
    # into [B, seq_len+1] (the +1 feeds the shift-by-one LM loss), with
    # segment_ids/positions fencing packed sequences in the attention mask
    all_files = tfr.list_shards(args.data_dir)
    files = shard_files(all_files, ctx.num_workers, ctx.executor_id)
    if not files:
        # fail loudly NOW: a worker with no data would sit out the
        # collective train steps and hang the whole world at step 1
        raise RuntimeError(
            "worker {} got 0 of {} shard files in {} — distributed training "
            "needs at least num_workers ({}) shard files".format(
                ctx.executor_id, len(all_files), args.data_dir, ctx.num_workers
            )
        )
    tokenizer = Tokenizer(
        kind=args.tokenizer,
        vocab_size=args.vocab_size if args.tokenizer == "word" else None,
    )
    if tokenizer.vocab_size > args.vocab_size:
        raise ValueError(
            "model vocab_size {} smaller than tokenizer vocab {}".format(
                args.vocab_size, tokenizer.vocab_size
            )
        )
    pipe = TextPipeline(
        files, tokenizer, seq_len=args.seq_len + 1, batch_size=args.batch_size,
        seed=ctx.executor_id, epochs=None, max_bad_records=args.max_bad_records,
    )
    stream = iter(pipe)
    # placed ahead through pinned buffers: whole windows of K for the loop,
    # single batches for the eager step
    feed = (loop_prefetch(stream, strategy, steps_per_loop) if loop is not None
            else device_prefetch(stream, strategy))

    launches0 = flash_attention.launch_counts()
    t0, metrics = time.perf_counter(), {}
    i = last_log = start_step
    calls = 0
    with record_function("train.fetch"):
        got = next(feed)
    while i < args.train_steps:
        n = min(steps_per_loop, args.train_steps - i)
        calls += 1
        traced = KernelTrace() if calls == args.trace_call else contextlib.nullcontext()
        with obs.span("train_step", step=i + n, steps=n) as sp:
            with traced as trace:
                with record_function("train.call"):
                    if n > 1 and n == steps_per_loop:
                        state, metrics = loop(state, got)
                    else:  # the eager step, or a tail shorter than K step by step
                        for batch in (got[:n] if loop is not None else [got]):
                            state, metrics = step(state, batch)
                i += n
                if i < args.train_steps:
                    with record_function("train.fetch"):
                        got = next(feed)  # the next call's batches, placed while this one runs
                if i - last_log >= args.log_steps or i >= args.train_steps:
                    with record_function("train.sync"):
                        loss = float(metrics["loss"])  # waits for the device
                    dt = time.perf_counter() - t0
                    tps = args.batch_size * args.seq_len * (i - last_log) / dt
                    sp.set(loss=loss, tokens_per_sec=tps)
                    print("step {}: loss {:.3f} ({:.0f} tokens/s)".format(i, loss, tps))
                    last_log, t0 = i, time.perf_counter()
            if trace is not None:
                sp.set(device_trace=trace.readings)
                print("device trace of call {}: {}".format(calls, json.dumps(trace.readings)))
    feed.close()
    stream.close()  # stop the producer before teardown
    if args.model_dir and ctx.process_id == 0:  # every rank holds the same state
        with obs.span("ckpt_save", step=args.train_steps):
            checkpoint.save_checkpoint(
                os.path.join(args.model_dir, "ckpt_{}".format(args.train_steps)), state)
    for name, n in flash_attention.launch_counts().items():
        obs.counter(
            "flash_attention_{}_launches_total".format(name[len("flash_"):]),
            help="launches of the flash-attention {} kernel by the training loop".format(name),
        ).inc(n - launches0[name])
    print(
        "transformer training complete: world={} packing_efficiency={:.3f}".format(
            ctx.num_processes, obs.gauge("text_pack_efficiency").value,
        )
    )


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--cluster_size", type=int, default=None,
                        help="explicit cluster size (default: from the Spark conf/parallelism under Spark; 1 on the local backend)")
    parser.add_argument("--d_ff", type=int, default=1024)
    parser.add_argument("--d_model", type=int, default=256)
    parser.add_argument("--data_dir", default=None,
                        help="TFRecord text shards (raw UTF-8 records); default: a deterministic synthetic corpus materialized on the driver")
    parser.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    parser.add_argument("--learning_rate", type=float, default=3e-4)
    parser.add_argument("--log_steps", type=int, default=10)
    parser.add_argument("--max_bad_records", type=int, default=0)
    parser.add_argument("--mesh", default=None,
                        help="dp only (model axes are not yet ported); default: all-dp")
    parser.add_argument("--model_dir", default=None,
                        help="checkpoint dir: resume from its newest checkpoint, save the final state")
    parser.add_argument("--moe_experts", type=int, default=0, help="not yet ported above 0")
    parser.add_argument("--n_heads", type=int, default=8)
    parser.add_argument("--n_layers", type=int, default=2)
    parser.add_argument("--pack_workers", type=int, default=0,
                        help="0 = in-process thread packing (forked pack workers are not yet ported)")
    parser.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                        help="device of each trainer: one CUDA device per process, or the CPU")
    parser.add_argument("--remat", action="store_true", help="not yet ported")
    parser.add_argument("--seq_len", type=int, default=256)
    parser.add_argument("--slab_cache_dir", default=None,
                        help="packed-slab cache root (not yet ported)")
    parser.add_argument("--steps_per_loop", type=int, default=1,
                        help="train steps a call of the train loop (on the card: one captured "
                             "CUDA graph, replayed)")
    parser.add_argument("--tokenizer", default="byte", choices=("byte", "word"))
    parser.add_argument("--trace_call", type=int, default=0, metavar="N",
                        help="trace the N-th train call (1-based; 0: none) with torch.profiler and "
                             "report what ran on the device (ops/kernel_trace.py); that call's span and "
                             "the printed rate across it include the profiler's start and read-out")
    parser.add_argument("--train_steps", type=int, default=20)
    parser.add_argument("--vocab_size", type=int, default=1024)
    return parser


def main(argv=None, sc=None):
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    if not args.data_dir:
        args.data_dir = os.path.join(tempfile.gettempdir(), "tos_transformer_corpus")
        shards = make_text_corpus(args.data_dir)
        print("synthetic text corpus: {} shards in {}".format(len(shards), args.data_dir))

    from tensorflowonspark_tpu_torch import TFCluster, util
    from tensorflowonspark_tpu_torch.backends import get_spark_context

    # spark-submit / pyspark when present, local backend otherwise;
    # a caller-supplied sc is passed through with owned=False
    sc, args.cluster_size, owned = get_spark_context(
        "transformer_spark", args.cluster_size, sc=sc, local_default=1
    )
    try:
        cluster = TFCluster.run(
            sc, main_fun, args, args.cluster_size,
            input_mode=TFCluster.InputMode.TENSORFLOW, master_node="chief",
            env={util.ENV_PLATFORM: args.platform},
        )
        cluster.shutdown()
        print("transformer run complete")
    finally:
        if owned:
            sc.stop()


if __name__ == "__main__":
    from tensorflowonspark_tpu_torch import util

    util.setup_logging()
    main()
