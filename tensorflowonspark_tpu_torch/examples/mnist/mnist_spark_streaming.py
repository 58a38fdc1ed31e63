"""MNIST training from a STREAM of micro-batches (InputMode.SPARK) — the port
of ``examples/mnist/mnist_spark_streaming.py``.

Micro-batches ("waves") flow into the synchronous feed plane, and the
training loop blocks in ``next_batch`` between waves. Stop either from the
driver (``--num_waves`` exhausted → ``cluster.shutdown(ssc)``) or
externally with ``python -m
tensorflowonspark_tpu_torch.examples.utils.stop_cluster <host> <port>`` (the
server address is printed at startup). The waves come through the local
backend's ``LocalStreamingContext`` (its ``feed()`` pushes them one by
one).

Usage::

    python -m tensorflowonspark_tpu_torch.examples.mnist.mnist_spark_streaming \\
        --cluster_size 1 --num_waves 5 --wave_rows 512
"""

import argparse
import time


def main_fun(args, ctx):
    """Runs inside the trainer child; trains for as long as micro-batches flow."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import obs
    from tensorflowonspark_tpu_torch.models import mnist
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim

    ctx.initialize_distributed()  # no-op for one process
    strategy = SyncDataParallel(ctx.device)
    model = mnist.create_model("mlp", hidden=args.hidden)
    optimizer = optim.adam(args.learning_rate)
    state = strategy.create_state(mnist.make_init_fn(model), optimizer, torch.Generator().manual_seed(0))
    step = strategy.compile_train_step(mnist.make_loss_fn(model, dropout_seed=ctx.process_id),
                                       optimizer, has_aux=True)

    feed = ctx.get_data_feed(train_mode=True)
    steps = rows = 0
    with obs.span("mnist_stream") as sp:
        while not feed.should_stop():
            # blocks while the stream is idle; returns when a batch fills or
            # the shutdown end-of-feed marker arrives
            batch = feed.next_batch(args.batch_size)
            if not batch:
                break
            images = np.asarray([b[0] for b in batch], np.float32).reshape(-1, 28, 28)
            labels = np.asarray([b[1] for b in batch])
            state, metrics = step(state, strategy.shard_batch({"image": images, "label": labels}))
            steps += 1
            rows += len(batch)
            if steps % args.log_steps == 0:
                print("streamed step {} loss {:.4f}".format(steps, float(metrics["loss"])))
        sp.set(steps=steps, rows=rows)
    print("stream ended after {} steps".format(steps))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--batch_interval", type=float, default=0.5)
    parser.add_argument("--cluster_size", type=int, default=1)
    parser.add_argument("--hidden", type=int, default=512, help="width of the MLP's hidden layer")
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--log_steps", type=int, default=10)
    parser.add_argument("--num_waves", type=int, default=5)
    parser.add_argument("--wave_rows", type=int, default=512)
    parser.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                        help="device of each trainer: one CUDA device per process, or the CPU")
    args = parser.parse_args(argv)

    from tensorflowonspark_tpu_torch import TFCluster, util
    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext, LocalStreamingContext
    from tensorflowonspark_tpu_torch.examples.mnist.mnist_data_setup import synthetic_mnist, to_rows

    sc = LocalSparkContext(num_executors=args.cluster_size)
    ssc = LocalStreamingContext(sc, batch_interval=args.batch_interval)
    try:
        cluster = TFCluster.run(
            sc, main_fun, args, args.cluster_size,
            input_mode=TFCluster.InputMode.SPARK, master_node="chief",
            env={util.ENV_PLATFORM: args.platform},
        )
        print("control plane at {}:{} (stop with python -m "
              "tensorflowonspark_tpu_torch.examples.utils.stop_cluster <host> <port>)".format(
            *cluster.cluster_meta["server_addr"]))
        stream = ssc.queueStream()
        cluster.train(stream)  # registers the micro-batch feed
        ssc.start()

        rows = to_rows(*synthetic_mnist(args.num_waves * args.wave_rows))
        for wave in range(args.num_waves):
            if cluster.stop_requested:
                print("external stop request — ending stream")
                break
            lo = wave * args.wave_rows
            ssc.feed(sc.parallelize(rows[lo:lo + args.wave_rows], 2))
            print("fed wave {}/{}".format(wave + 1, args.num_waves))
            time.sleep(args.batch_interval)

        cluster.shutdown(ssc=ssc, grace_secs=5)
        print("streaming training complete")
    finally:
        sc.stop()


if __name__ == "__main__":
    from tensorflowonspark_tpu_torch import util

    util.setup_logging()
    main()
