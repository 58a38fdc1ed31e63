"""MNIST training with InputMode.TENSORFLOW — the port of
``examples/mnist/mnist_tf.py``: each node reads its own shard of the
TFRecords (``mnist_data_setup --format tfrecords``) directly from the
filesystem, with no feed queues.

Usage::

    python -m tensorflowonspark_tpu_torch.examples.mnist.mnist_data_setup --output /tmp/mnist_tfr
    python -m tensorflowonspark_tpu_torch.examples.mnist.mnist_tf --data_dir /tmp/mnist_tfr --cluster_size 1
"""

import argparse


def main_fun(args, ctx):
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import obs, tfrecord
    from tensorflowonspark_tpu_torch.models import mnist
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim

    ctx.initialize_distributed()
    strategy = SyncDataParallel(ctx.device)
    model = mnist.create_model("mlp", hidden=args.hidden)
    optimizer = optim.adam(args.learning_rate)
    state = strategy.create_state(mnist.make_init_fn(model), optimizer, torch.Generator().manual_seed(0))
    step = strategy.compile_train_step(mnist.make_loss_fn(model, dropout_seed=ctx.process_id),
                                       optimizer, has_aux=True)

    # this worker's shard of the files (reference: ds.shard(num_workers, i))
    shards = tfrecord.list_shards(args.data_dir)
    my_rank = ctx.executor_id
    my_files = [s for i, s in enumerate(shards) if i % ctx.num_workers == my_rank % ctx.num_workers]

    def batches():
        images, labels = [], []
        for _ in range(args.epochs):
            for path in my_files:
                for ex in tfrecord.read_examples(path):
                    images.append(np.asarray(ex["image"][1], np.float32).reshape(28, 28))
                    labels.append(int(ex["label"][1][0]))
                    if len(images) == args.batch_size:
                        yield {"image": np.stack(images), "label": np.asarray(labels)}
                        images, labels = [], []

    metrics = {}
    steps = 0
    with obs.span("mnist_train") as sp:
        for i, batch in enumerate(batches()):
            state, metrics = step(state, strategy.shard_batch(batch))
            steps = i + 1
            if steps % 100 == 0:
                print("step {} loss {:.4f} acc {:.3f}".format(
                    steps, float(metrics["loss"]), float(metrics["accuracy"])))
        sp.set(steps=steps, rows=steps * args.batch_size)
    if metrics:
        print("final: loss {:.4f} acc {:.3f}".format(
            float(metrics["loss"]), float(metrics["accuracy"])))


def main(argv=None, sc=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--cluster_size", type=int, default=None,
                        help="explicit cluster size (default: from the Spark conf/parallelism under "
                             "Spark; 1 on the local backend)")
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--hidden", type=int, default=512, help="width of the MLP's hidden layer")
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                        help="device of each trainer: one CUDA device per process, or the CPU")
    args = parser.parse_args(argv)

    from tensorflowonspark_tpu_torch import TFCluster, util
    from tensorflowonspark_tpu_torch.backends import get_spark_context

    # spark-submit / pyspark when present, local backend otherwise;
    # a caller-supplied sc is passed through with owned=False
    sc, args.cluster_size, owned = get_spark_context("mnist_tf", args.cluster_size, sc=sc,
                                                     local_default=1)
    try:
        cluster = TFCluster.run(
            sc, main_fun, args, args.cluster_size,
            input_mode=TFCluster.InputMode.TENSORFLOW, master_node="chief",
            env={util.ENV_PLATFORM: args.platform},
        )
        cluster.shutdown()
        print("training complete")
    finally:
        if owned:
            sc.stop()


if __name__ == "__main__":
    from tensorflowonspark_tpu_torch import util

    util.setup_logging()
    main()
