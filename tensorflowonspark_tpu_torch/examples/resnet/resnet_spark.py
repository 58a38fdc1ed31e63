"""ResNet training on a cluster — the port of ``examples/resnet/resnet_spark.py``.

``--dataset imagenet`` trains ResNet-50 v1.5 (base LR 0.1·bs/256 with a
linear warmup), ``--dataset cifar`` ResNet-56 (piecewise LR), both with SGD
momentum 0.9 and the L2 term in the loss. Input, as in the JAX example:

* ``--data_dir <tfrecords>`` — real data: the worker's share of the TFRecord
  shards (``shard_files``) through the port's
  :class:`~tensorflowonspark_tpu_torch.data.ImagePipeline` (the native
  reader and JPEG decoder, a thread pool of ``--data_threads``, or the
  forked decode plane with ``TOS_DECODE_WORKERS``; the decoded-slab cache
  with ``TOS_SLAB_CACHE_DIR``), placed ahead through pinned buffers. ImageNet
  batches ship as uint8 and are normalized on the card. The pipeline's
  iterator is taken before the trainer touches CUDA, so the decode plane
  forks from a process without a CUDA context. A worker with no shard fails
  at once. Shards come from ``resnet_data_setup.py``.
* otherwise the reference's synthetic path (one seeded random batch per
  worker, re-fed every step).

``--eval_dir`` scores top-1 after training on the first worker, over all
eval shards, with no collective and the short last batch kept. Each node's
trainer child runs on ``--platform`` (default ``gpu``: one CUDA device per
process; ``gpu`` without a CUDA device raises). ``--bn_impl pallas`` runs
every BatchNorm through the port's kernels; ``flax`` is plain PyTorch math.
With more than one worker both take the statistics over the global batch.

Usage (one executor, one H100)::

    python -m tensorflowonspark_tpu_torch.examples.resnet.resnet_spark \\
        --dataset imagenet --bn_impl pallas --batch_size 64 --train_steps 5

``--steps_per_loop K`` runs K steps a call through
``SyncDataParallel.compile_train_loop``, as the JAX example does: on the
card the step is captured once in a CUDA graph and replayed (the first two
steps run eagerly as its warm-up); a tail shorter than K runs step by step.

Each logged step (or loop of K steps) lands in the node's obs registry as a
``train_step`` span (its last step, the steps it ran, loss, images/s; on
real data also the input plane's stall counters so far) and
the BN kernel wrappers' launches as ``fused_bn_<kernel>_launches_total``
counters (eager launches and launches into a captured graph), so the Spark
driver reads them from ``cluster.metrics()``. ``--trace_call N`` traces the
N-th call with ``torch.profiler`` (``ops/kernel_trace.KernelTrace``): the
device kernels of each wrapper (a replayed graph's too), graph launches,
device busy ms and idle share, and the host ms in ``train.call`` /
``train.sync``, printed and set on that call's span as ``device_trace``.

Checkpoints, as in the JAX example: with ``--model_dir`` a run resumes
from the newest restorable checkpoint there (``checkpoint.restore_latest``,
copied into the live state in place), saves every ``--checkpoint_steps``
steps on loop-call boundaries and at the end, keeping the newest
``--keep_checkpoints``; rank 0 saves (every rank holds the same state) and
every rank restores. Saves and restores are ``ckpt_save`` / ``ckpt_restore``
spans. ``--auto_recover N`` (with ``--model_dir`` and
``--checkpoint_steps``) runs through ``TFCluster.run_with_recovery``: a lost
node relaunches the cluster up to N times, and the trainer resumes from its
checkpoint. ``--deterministic`` selects cuDNN's deterministic algorithms, so
a resumed run equals an uninterrupted one bitwise.

``--profile_steps START[,STOP]`` traces that step range with
``torch.profiler`` into ``<model_dir or .>/profile/trace.json`` (a Chrome
trace); it cannot be combined with ``--trace_call``.
"""

import argparse

#: the input plane's stall accounting, set on each train_step span of a
#: real-data run (cumulative seconds)
STALL_COUNTERS = ("data_producer_read_seconds_total", "data_producer_parse_seconds_total",
                  "data_producer_emit_seconds_total", "data_consumer_wait_seconds_total")


def lr_schedule(args):
    """Reference schedules: piecewise for CIFAR, warmup+scaled for ImageNet."""
    from tensorflowonspark_tpu_torch.train import optim

    if args.dataset == "cifar":
        # (0.1, 91ep) (0.01, 136ep) (0.001, 182ep) — in steps
        spe = max(args.steps_per_epoch, 1)
        return optim.piecewise_constant_schedule(0.1, {91 * spe: 0.1, 136 * spe: 0.1})
    base = 0.1 * args.batch_size / 256.0
    warmup = 5 * max(args.steps_per_epoch, 1)
    return optim.linear_schedule(0.0, base, warmup)


def _image_pipeline(args, ctx, image_size, feed_uint8, training):
    """The worker's train stream (its share of ``--data_dir``, endless,
    shuffled) or the eval stream (every ``--eval_dir`` shard once, in
    order, the short last batch kept), as an iterator: the decode plane, if
    one is asked for, has forked when this returns."""
    from tensorflowonspark_tpu_torch import tfrecord as tfr
    from tensorflowonspark_tpu_torch.data import ImagePipeline, cifar, imagenet, shard_files

    seed = ctx.executor_id if training else 0
    if args.dataset == "cifar":
        parse = cifar.make_parse_fn(training, seed=seed)
    else:
        parse = imagenet.make_parse_fn(training, image_size=image_size, label_offset=args.label_offset,
                                       seed=seed, raw_uint8=feed_uint8)
    if not training:
        files = tfr.list_shards(args.eval_dir)
        return iter(ImagePipeline(files, parse, args.batch_size, shuffle=False, epochs=1,
                                  drop_remainder=False, num_threads=args.data_threads))
    all_files = tfr.list_shards(args.data_dir)
    files = shard_files(all_files, ctx.num_workers, ctx.executor_id)
    if not files:
        # fail loudly NOW: a worker with no data would sit out the
        # collective train steps and hang the whole world at step 1
        raise RuntimeError(
            "worker {} got 0 of {} shard files in {} — distributed training needs at least "
            "num_workers ({}) shard files".format(ctx.executor_id, len(all_files), args.data_dir,
                                                  ctx.num_workers))
    return iter(ImagePipeline(files, parse, args.batch_size, seed=ctx.executor_id, epochs=None,
                              num_threads=args.data_threads))


def main_fun(args, ctx):
    import collections
    import contextlib
    import json
    import os
    import time

    import numpy as np
    import torch
    from torch.autograd.profiler import record_function

    from tensorflowonspark_tpu_torch import obs
    from tensorflowonspark_tpu_torch.data import device_prefetch, imagenet, loop_prefetch
    from tensorflowonspark_tpu_torch.models import resnet
    from tensorflowonspark_tpu_torch.ops import fused_bn
    from tensorflowonspark_tpu_torch.ops.kernel_trace import KernelTrace
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, checkpoint, optim

    if args.dataset == "cifar":
        build, image_size, classes = resnet.resnet56, 32, 10
    else:
        build, image_size, classes = resnet.resnet50, 224, 1000
    if args.image_size:
        image_size = args.image_size
    use_real = bool(args.data_dir)
    # imagenet real data feeds raw uint8 (a quarter of the host→device
    # bytes); the mean subtraction runs on the card
    feed_uint8 = use_real and args.dataset == "imagenet"
    # the input streams first: a decode plane forks its workers as its
    # iterator is taken, and this process has no CUDA context yet
    stream = _image_pipeline(args, ctx, image_size, feed_uint8, True) if use_real else None
    eval_stream = None
    if args.eval_dir and ctx.executor_id == 0:
        eval_stream = _image_pipeline(args, ctx, image_size, feed_uint8, False)

    if args.deterministic:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    ctx.initialize_distributed()
    strategy = SyncDataParallel(ctx.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    optimizer = optim.sgd(lr_schedule(args), momentum=0.9)
    generator = torch.Generator().manual_seed(0)  # the reference's PRNGKey(0)
    state = strategy.create_state(
        lambda: build(dtype=dtype, bn_impl=args.bn_impl, generator=generator), optimizer
    )
    normalize = imagenet.device_normalize if feed_uint8 else None
    loss_fn = resnet.make_loss_fn(weight_decay=1e-4, normalize=normalize)
    # every rank holds the same state (global gradients and BN statistics):
    # one saver, or several ranks would race on one directory; every rank
    # restores
    is_saver = ctx.process_id == 0
    start_step = 0
    if args.model_dir:
        with obs.span("ckpt_restore") as sp:
            # the crash→relaunch contract (TFCluster.run_with_recovery and
            # job resubmission both land here): continue at the newest
            # restorable checkpoint, copied into the live state in place
            restored, latest = checkpoint.restore_latest(args.model_dir, target=state)
            sp.set(path=latest, step=restored.step if latest else 0)
        if latest:
            start_step = state.step
            print("resuming from {} at step {}".format(latest, start_step))
    step = strategy.compile_train_step(loss_fn, optimizer, mutable=True)
    steps_per_loop = max(args.steps_per_loop or 1, 1)
    loop = None
    if steps_per_loop > 1:
        # K steps a call: on the card one captured CUDA graph, replayed
        loop = strategy.compile_train_loop(loss_fn, optimizer, steps_per_loop, mutable=True)

    if use_real:
        # placed ahead through pinned buffers: windows of K for the loop,
        # single batches for the eager step
        feed = (loop_prefetch(stream, strategy, steps_per_loop) if loop is not None
                else ([b] for b in device_prefetch(stream, strategy)))
    else:
        rng = np.random.default_rng(ctx.executor_id)
        synthetic = strategy.shard_batch(
            {
                "image": rng.standard_normal((args.batch_size, image_size, image_size, 3)).astype(np.float32),
                "label": rng.integers(0, classes, args.batch_size),
            }
        )
        feed = iter(lambda: [synthetic], None)  # repeat forever
    pending = collections.deque()

    def take(i):
        """The batches of the call that starts at step ``i``: a loop's K,
        or one for an eager step (and for each step of a tail shorter than
        K)."""
        n = steps_per_loop if loop is not None and i + steps_per_loop <= args.train_steps else 1
        while len(pending) < n:
            pending.extend(next(feed))
        return [pending.popleft() for _ in range(n)]

    profile_range, profiler, trace_dir = None, None, None
    if args.profile_steps:
        # reference: --profile_steps -> profiler callback over a step range
        # (common.py:192-197); here torch.profiler traces the same range
        lo, _, hi = args.profile_steps.partition(",")
        profile_range = (int(lo), int(hi or lo))
        trace_dir = os.path.join(args.model_dir or ".", "profile")

    def stop_profiler():
        if strategy.device.type == "cuda":
            torch.cuda.synchronize()
        profiler.stop()
        os.makedirs(trace_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        print("profiler trace written to {}".format(trace_dir))

    launches0 = fused_bn.launch_counts()
    t0, metrics = time.perf_counter(), {}
    i = last_log = last_ckpt = start_step
    calls = 0
    with record_function("train.fetch"):
        got = take(i) if i < args.train_steps else []
    while i < args.train_steps:
        if profile_range and profiler is None and i >= profile_range[0]:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if strategy.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()
        n = len(got)
        calls += 1
        traced = KernelTrace() if calls == args.trace_call else contextlib.nullcontext()
        with obs.span("train_step", step=i + n, steps=n) as sp:
            with traced as trace:
                with record_function("train.call"):
                    if n > 1:
                        state, metrics = loop(state, got)
                    else:
                        state, metrics = step(state, got[0])
                i += n
                if i < args.train_steps:
                    with record_function("train.fetch"):
                        got = take(i)  # the next call's batches, placed while this one runs
                if i - last_log >= args.log_steps:
                    with record_function("train.sync"):
                        loss = float(metrics["loss"])  # waits for the device
                    dt = time.perf_counter() - t0
                    # avg_exp_per_second analogue (reference common.py:241-244)
                    ips = args.batch_size * (i - last_log) / dt
                    sp.set(loss=loss, images_per_sec=ips)
                    print("step {}: loss {:.3f} {:.1f} img/s".format(i, loss, ips))
                    last_log, t0 = i, time.perf_counter()
            if trace is not None:
                sp.set(device_trace=trace.readings)
                print("device trace of call {}: {}".format(calls, json.dumps(trace.readings)))
            if stream is not None:
                # the input plane's stall counters so far: deltas between two
                # calls' spans classify an interval (past the first call's
                # build and capture, during which the producer only waits)
                sp.set(**{name: obs.counter(name).value for name in STALL_COUNTERS})
        if profiler is not None and profile_range and i >= profile_range[1]:
            stop_profiler()
            profile_range = None  # captured once; never re-trigger
        if args.model_dir and args.checkpoint_steps and is_saver and i - last_ckpt >= args.checkpoint_steps:
            with obs.span("ckpt_save", step=i):
                checkpoint.save_checkpoint(os.path.join(args.model_dir, "ckpt_{}".format(i)), state)
            last_ckpt = i
            checkpoint.prune_checkpoints(args.model_dir, args.keep_checkpoints)
    if profiler is not None and profile_range:
        stop_profiler()  # a stop boundary past train_steps still flushes the trace
    if stream is not None:
        feed.close()
        stream.close()  # stop the producer (and the decode plane) before teardown
    if metrics and args.model_dir and is_saver and last_ckpt < args.train_steps:
        with obs.span("ckpt_save", step=i):
            checkpoint.save_checkpoint(os.path.join(args.model_dir, "ckpt_{}".format(i)), state)
    for name, n in fused_bn.launch_counts().items():
        obs.counter(
            "fused_bn_{}_launches_total".format(name),
            help="launches of the fused-BN {} kernel by the training loop".format(name),
        ).inc(n - launches0[name])
    if metrics:
        print("final loss {:.3f}".format(float(metrics["loss"])))

    if eval_stream is not None:
        # the reference's per-run top-1 eval (resnet_imagenet_main.py):
        # aspect-preserving resize + central crop, no augmentation, on the
        # first worker only, over ALL eval shards: eval must not enter
        # collectives, and must score every example
        eval_fn = resnet.make_eval_fn(normalize=normalize)
        state.module.eval()
        correct = total = 0
        with obs.span("eval") as sp:
            for b in eval_stream:
                c, n = eval_fn(state.module, state.model_state, strategy.shard_batch(b))
                correct += int(c)
                total += int(n)
            state.module.train()
            if total:
                sp.set(correct=correct, examples=total, accuracy=correct / total)
                print("eval accuracy {:.4f} ({} examples)".format(correct / total, total))


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--bn_impl", choices=["flax", "pallas"], default="flax",
                        help="BatchNorm: 'pallas' runs the port's kernels, 'flax' "
                             "plain PyTorch math; both global over the workers")
    parser.add_argument("--cluster_size", type=int, default=None,
                        help="explicit cluster size (default: from the Spark conf/parallelism under Spark; 1 on the local backend)")
    parser.add_argument("--data_dir", default=None, help="TFRecord shard dir (real-data mode)")
    parser.add_argument("--data_threads", type=int, default=8,
                        help="decode threads of the input pipeline (TOS_DECODE_WORKERS > 0 forks "
                             "decode processes instead)")
    parser.add_argument("--dataset", choices=["cifar", "imagenet"], default="cifar")
    parser.add_argument("--eval_dir", default=None,
                        help="TFRecord shard dir for post-training top-1 eval")
    parser.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16")
    parser.add_argument("--image_size", type=int, default=None,
                        help="override the dataset's native size (tests/CI)")
    parser.add_argument("--label_offset", type=int, default=0,
                        help="-1 for 1-based ImageNet labels")
    parser.add_argument("--log_steps", type=int, default=20)
    parser.add_argument("--steps_per_loop", type=int, default=1,
                        help="train steps a call of the train loop (on the card: one captured "
                             "CUDA graph, replayed)")
    parser.add_argument("--model_dir", default=None,
                        help="checkpoint dir: resume from its newest checkpoint, save into it")
    parser.add_argument("--checkpoint_steps", type=int, default=0, metavar="N",
                        help="checkpoint every N steps into --model_dir (0 = final checkpoint only)")
    parser.add_argument("--keep_checkpoints", type=int, default=5, metavar="K",
                        help="retain only the newest K periodic checkpoints")
    parser.add_argument("--deterministic", action="store_true",
                        help="cuDNN deterministic algorithms: bitwise-reproducible runs")
    parser.add_argument("--profile_steps", default=None, metavar="START[,STOP]",
                        help="trace this step range with torch.profiler into <model_dir or .>/profile "
                             "(reference --profile_steps, common.py:192-197)")
    parser.add_argument("--steps_per_epoch", type=int, default=390)
    parser.add_argument("--trace_call", type=int, default=0, metavar="N",
                        help="trace the N-th train call (1-based; 0: none) with torch.profiler and "
                             "report what ran on the device (ops/kernel_trace.py); that call's span and "
                             "the printed rate across it include the profiler's start and read-out")
    parser.add_argument("--train_steps", type=int, default=100)
    parser.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                        help="device of each trainer: one CUDA device per process, or the CPU")
    parser.add_argument("--auto_recover", type=int, default=0, metavar="N",
                        help="relaunch the cluster up to N times on node failure, resuming from "
                             "the latest checkpoint (pair with --model_dir + --checkpoint_steps; "
                             "TFCluster.run_with_recovery)")
    return parser


def main(argv=None, sc=None):
    """Run the example; returns the relaunches ``--auto_recover`` made (0
    without it)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.profile_steps and args.trace_call:
        parser.error("--profile_steps and --trace_call both run torch.profiler: pick one")
    if args.auto_recover and not (args.model_dir and args.checkpoint_steps):
        # without a mid-run checkpoint to resume from, every relaunch would
        # silently restart at step 0 — refuse the misconfiguration up front
        parser.error("--auto_recover requires --model_dir and --checkpoint_steps")

    from tensorflowonspark_tpu_torch import TFCluster, util
    from tensorflowonspark_tpu_torch.backends import get_spark_context

    # spark-submit / pyspark when present, local backend otherwise;
    # a caller-supplied sc is passed through with owned=False
    sc, args.cluster_size, owned = get_spark_context(
        "resnet_spark", args.cluster_size, sc=sc, local_default=1
    )
    env = {util.ENV_PLATFORM: args.platform}
    relaunches = 0
    try:
        if args.auto_recover:
            relaunches = TFCluster.run_with_recovery(
                sc, main_fun, args, args.cluster_size, max_relaunches=args.auto_recover,
                input_mode=TFCluster.InputMode.TENSORFLOW, master_node="chief", env=env,
            )
            print("resnet training complete ({} relaunch(es))".format(relaunches))
        else:
            cluster = TFCluster.run(
                sc, main_fun, args, args.cluster_size,
                input_mode=TFCluster.InputMode.TENSORFLOW, master_node="chief", env=env,
            )
            cluster.shutdown()
            print("resnet training complete")
    finally:
        if owned:
            sc.stop()
    return relaunches


if __name__ == "__main__":
    from tensorflowonspark_tpu_torch import util

    util.setup_logging()
    main()
