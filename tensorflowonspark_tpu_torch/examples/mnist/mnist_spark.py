"""MNIST training with InputMode.SPARK — the port of
``examples/mnist/mnist_spark.py``: RDD partitions stream into the cluster's
feed queues and each node's trainer child trains on its device.

The JAX example's flow: ``ctx.get_data_feed(train_mode=True)``, then
``next_batch`` → ``shard_batch`` → an Adam train step of the MLP, capped at
90% of the expected steps (``steps_per_worker``: Spark partitions are
uneven, and a rank that runs dry would hang the others' all-reduce). Rows
are the reference's ``(image as 784 floats, label)``. With ``--model_dir``
the run resumes from the newest checkpoint there and saves every
``--checkpoint_steps`` steps (one saver: rank 0 of a torch.distributed
world, whose ranks hold the same state, or else the chief); the chief
exports a model bundle to ``--export_dir``. ``--auto_recover N`` runs
through ``TFCluster.run_with_recovery(feed_fn=...)``, which re-feeds the
RDD to a relaunched cluster. Each trainer runs on ``--platform`` (default
``gpu``: one CUDA device a process, raising without one).

The trainer publishes, through its obs plane: ``train_steps_total`` and
``train_examples_per_sec`` (``TimeHistory``), ``train_rows_total`` (feed
rows it trained on), an ``mnist_train`` span (steps, rows, first and last
loss, the seconds from the first step to the last step's result, images/s,
the rank, a SHA-256 of its final parameters' bytes, and the host seconds
spent in ``next_batch`` (after the first), in building and placing the
numpy batch, and in the step's call)
and each kernel wrapper's launches as ``<wrapper>_launches_total`` (the
MNIST models call none of the port's kernels). :func:`main` returns them
as ``cluster.metrics`` read when the trainers are done, beside the seconds
``cluster.train`` took (the epochs' feed, end to end).

Usage (one executor, one card)::

    python -m tensorflowonspark_tpu_torch.examples.mnist.mnist_spark \\
        --cluster_size 1 --epochs 1 --num_examples 60000 \\
        --model_dir /tmp/mnist_model --export_dir /tmp/mnist_export
"""

import argparse
import time


def main_fun(args, ctx):
    """Runs inside the trainer child of every cluster node."""
    import hashlib
    import os

    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import obs, util
    from tensorflowonspark_tpu_torch.models import mnist
    from tensorflowonspark_tpu_torch.ops import kernel_trace
    from tensorflowonspark_tpu_torch.train import (
        SyncDataParallel, TimeHistory, checkpoint, export, optim, steps_per_worker,
    )

    ctx.initialize_distributed()  # no-op for one process
    strategy = SyncDataParallel(ctx.device)
    model = mnist.create_model("mlp", hidden=args.hidden)
    optimizer = optim.adam(args.learning_rate)
    state = strategy.create_state(mnist.make_init_fn(model), optimizer, torch.Generator().manual_seed(0))
    # each rank draws its own dropout masks, as its rows of the JAX
    # version's global batch do
    step = strategy.compile_train_step(mnist.make_loss_fn(model, dropout_seed=ctx.process_id),
                                       optimizer, has_aux=True)
    # every rank of a world holds the same state: one saver; independent
    # single-process nodes: only the chief, or the workers would race on
    # the same checkpoint directory
    is_saver = ctx.process_id == 0 if util.world_size() > 1 else (
        ctx.job_name in ("chief", "master") or ctx.num_workers <= 1)
    start_step = 0
    if args.model_dir:
        # resume contract (run_with_recovery / job resubmission): continue
        # from the newest restorable checkpoint, copied into the state
        with obs.span("ckpt_restore") as sp:
            _, latest = checkpoint.restore_latest(args.model_dir, target=state)
            sp.set(path=latest, step=state.step if latest else 0)
        if latest:
            start_step = state.step
            print("resuming from {} at step {}".format(latest, start_step))

    launches0 = {fn.__name__: fn.launches for fn in kernel_trace.counted_wrappers()}
    rows_c = obs.counter("train_rows_total", help="feed rows the trainer trained on")
    history = TimeHistory(args.batch_size, args.log_steps)
    max_steps = steps_per_worker(args.num_examples * args.epochs, args.batch_size, ctx.num_workers)
    feed = ctx.get_data_feed(train_mode=True)
    steps, rows, losses = start_step, 0, []
    t_first = metrics = None
    # host seconds in the feed, in building the numpy batch and placing it,
    # and in the step's call (which queues the device's work)
    host = {"feed_s": 0.0, "batch_s": 0.0, "step_s": 0.0}
    with obs.span("mnist_train", start_step=start_step, max_steps=max_steps) as sp:
        while not feed.should_stop() and steps < max_steps:
            t0 = time.perf_counter()
            batch = feed.next_batch(args.batch_size)
            if not batch:
                break
            t1 = time.perf_counter()
            if t_first is None:
                t_first = t1
            images = np.asarray([b[0] for b in batch], np.float32).reshape(-1, 28, 28)
            labels = np.asarray([b[1] for b in batch])
            placed = strategy.shard_batch({"image": images, "label": labels})
            t2 = time.perf_counter()
            state, metrics = step(state, placed)
            t3 = time.perf_counter()
            if steps > start_step:  # the first fetch waits for the feed to start
                host["feed_s"] += t1 - t0
            host["batch_s"] += t2 - t1
            host["step_s"] += t3 - t2
            steps += 1
            rows += len(batch)
            rows_c.inc(len(batch))
            history.batch_end()
            if not losses:
                losses.append(float(metrics["loss"]))
            if steps % args.log_steps == 0:
                print("step {} loss {:.4f} acc {:.3f}".format(
                    steps, float(metrics["loss"]), float(metrics["accuracy"])))
            if args.model_dir and steps % args.checkpoint_steps == 0 and is_saver:
                with obs.span("ckpt_save", step=steps):
                    checkpoint.save_checkpoint(os.path.join(args.model_dir, "ckpt_{}".format(steps)), state)
        if metrics is not None:
            losses.append(float(metrics["loss"]))  # waits for the last step
        seconds = time.perf_counter() - t_first if t_first is not None else 0.0
        # replicas of a world must end bitwise equal: a digest of the bytes
        digest = hashlib.sha256(b"".join(
            p.detach().cpu().numpy().tobytes() for p in state.params.values())).hexdigest()
        sp.set(steps=steps - start_step, rows=rows, first_loss=losses[0] if losses else None,
               last_loss=losses[-1] if losses else None, train_s=seconds,
               images_per_sec=rows / seconds if seconds else None, device=str(ctx.device),
               rank=ctx.process_id, params_sha256=digest, **host)
        # inside the span: a reader that waits for the span (await_trainers)
        # must find the counters in the same published snapshot
        for fn in kernel_trace.counted_wrappers():
            obs.counter("{}_launches_total".format(fn.__name__),
                        help="launches of the {} kernel by the training loop".format(fn.__name__)
                        ).inc(fn.launches - launches0[fn.__name__])
    if not feed.should_stop():
        feed.terminate()
    print("trained {} steps on {} rows".format(steps - start_step, rows))

    if args.export_dir and ctx.job_name in ("chief", "master"):
        with obs.span("export"):
            export.export_model(args.export_dir, mnist.bundle_builder("mlp", hidden=args.hidden),
                                state.params)
        print("exported model bundle to", args.export_dir)


def await_trainers(cluster, span="mnist_train", timeout=120):
    """``cluster.metrics(include_driver=False)`` once every worker's
    trainer has published ``span`` (it closes when the trainer is done
    training); raises after ``timeout`` seconds."""
    deadline = time.time() + timeout
    nodes = len([r for r in cluster.cluster_info if r["job_name"] in ("chief", "master", "worker")])
    while True:
        metrics = cluster.metrics(include_driver=False)
        done = [e for e in metrics.get("events", []) if e.get("span") == span]
        if len(done) >= nodes or cluster.tf_status.get("error"):
            return metrics  # a failed node: cluster.shutdown raises its error
        if time.time() > deadline:
            raise TimeoutError("{} of {} trainers published {!r} within {} s".format(
                len(done), nodes, span, timeout))
        time.sleep(0.5)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--checkpoint_steps", type=int, default=100)
    parser.add_argument("--cluster_size", type=int, default=None,
                        help="explicit cluster size (default: from the Spark conf/parallelism under "
                             "Spark; 1 on the local backend)")
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--hidden", type=int, default=512, help="width of the MLP's hidden layer")
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--log_steps", type=int, default=100)
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--export_dir", default=None)
    parser.add_argument("--num_examples", type=int, default=4096)
    parser.add_argument("--num_partitions", type=int, default=8)
    parser.add_argument("--tensorboard", action="store_true")
    parser.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                        help="device of each trainer: one CUDA device per process, or the CPU")
    parser.add_argument(
        "--auto_recover", type=int, default=0, metavar="N",
        help="relaunch budget on node failure: run_with_recovery(feed_fn=...) "
             "re-feeds the RDD against the relaunched cluster and nodes resume "
             "from --model_dir's newest checkpoint (requires --model_dir)")
    parser.add_argument(
        "--jax_distributed", choices=["auto", "0", "1"], default="auto",
        help="force the cross-process torch.distributed world on/off (the JAX "
             "example's flag name; auto = on when >1 training node)")
    return parser


def main(argv=None, sc=None):
    """Run the example. Returns ``{"relaunches", "train_s", "metrics"}``:
    the relaunches ``--auto_recover`` made, the seconds ``cluster.train``
    took, and the trainers' merged metrics (both None under
    ``--auto_recover``, whose ladder owns the cluster)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    jax_distributed = None if args.jax_distributed == "auto" else args.jax_distributed == "1"
    if args.auto_recover and not args.model_dir:
        parser.error("--auto_recover needs --model_dir (the resume point)")

    from tensorflowonspark_tpu_torch import TFCluster, util
    from tensorflowonspark_tpu_torch.backends import get_spark_context
    from tensorflowonspark_tpu_torch.examples.mnist.mnist_data_setup import synthetic_mnist, to_rows

    data = to_rows(*synthetic_mnist(args.num_examples))

    # spark-submit / pyspark when present, local backend otherwise;
    # a caller-supplied sc is passed through with owned=False
    sc, args.cluster_size, owned = get_spark_context("mnist_spark", args.cluster_size, sc=sc,
                                                     local_default=1)
    env = {util.ENV_PLATFORM: args.platform}
    result = {"relaunches": 0, "train_s": None, "metrics": None}
    try:
        if args.auto_recover:
            # SPARK-mode recovery: the caller owns the feed, so recovery
            # means re-invoking this feed loop against the relaunched
            # cluster; main_fun resumes from the newest checkpoint
            def feed_fn(cluster):
                cluster.train(sc.parallelize(data, args.num_partitions), num_epochs=args.epochs)

            result["relaunches"] = TFCluster.run_with_recovery(
                sc, main_fun, args, args.cluster_size,
                max_relaunches=args.auto_recover,
                input_mode=TFCluster.InputMode.SPARK, master_node="chief",
                tensorboard=args.tensorboard, env=env, feed_fn=feed_fn,
                jax_distributed=jax_distributed,
            )
            print("training complete ({} relaunch(es))".format(result["relaunches"]))
        else:
            cluster = TFCluster.run(
                sc, main_fun, args, args.cluster_size,
                input_mode=TFCluster.InputMode.SPARK, master_node="chief",
                tensorboard=args.tensorboard, env=env,
                jax_distributed=jax_distributed,
            )
            rdd = sc.parallelize(data, args.num_partitions)
            try:
                t0 = time.perf_counter()
                cluster.train(rdd, num_epochs=args.epochs)
                result["train_s"] = time.perf_counter() - t0
                result["metrics"] = await_trainers(cluster)
            finally:
                # also after a failed feed: stop the nodes and the
                # reservation server (shutdown raises the node's error)
                cluster.shutdown(grace_secs=5)
            print("training complete")
    finally:
        if owned:
            sc.stop()
    return result


if __name__ == "__main__":
    from tensorflowonspark_tpu_torch import util

    util.setup_logging()
    main()
