"""MNIST through the Spark-ML pipeline API — the port of
``examples/mnist/mnist_pipeline.py``: ``TFEstimator(train_fun).fit(df)``
trains on a cluster fed from the DataFrame (InputMode.SPARK) and the chief
exports a model bundle; the :class:`TFModel` it returns then runs
``transform(df)``, batch inference from the bundle inside the executors.
Training and inference run on ``--platform`` (default ``gpu``).

Usage::

    python -m tensorflowonspark_tpu_torch.examples.mnist.mnist_pipeline \\
        --cluster_size 1 --export_dir /tmp/mnist_bundle
"""

import argparse


def train_fun(args, ctx):
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.models import mnist
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, export, optim

    strategy = SyncDataParallel(ctx.device)
    model = mnist.create_model("mlp", hidden=args.hidden)
    optimizer = optim.adam(1e-3)
    state = strategy.create_state(mnist.make_init_fn(model), optimizer, torch.Generator().manual_seed(0))
    step = strategy.compile_train_step(mnist.make_loss_fn(model, dropout_seed=ctx.process_id),
                                       optimizer, has_aux=True)

    feed = ctx.get_data_feed(train_mode=True)
    while not feed.should_stop():
        batch = feed.next_batch(args.batch_size)
        if not batch:
            break
        images = np.asarray([b[0] for b in batch], np.float32).reshape(-1, 28, 28)
        labels = np.asarray([b[1] for b in batch])
        state, _ = step(state, strategy.shard_batch({"image": images, "label": labels}))

    if ctx.job_name in ("chief", "master"):
        export.export_model(args.export_dir, mnist.bundle_builder("mlp", hidden=args.hidden),
                            state.params)


def main(argv=None, sc=None):
    """Run the example. Returns ``(predictions, labels, devices)`` of the
    inference rows (``--num_test`` rows of the training data, in order):
    each row's predicted class, its label and the device its executor
    predicted on."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--cluster_size", type=int, default=None,
                        help="explicit cluster size (default: from the Spark conf/parallelism under "
                             "Spark; 1 on the local backend)")
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--export_dir", required=True)
    parser.add_argument("--hidden", type=int, default=512, help="width of the MLP's hidden layer")
    parser.add_argument("--num_examples", type=int, default=4096)
    parser.add_argument("--num_test", type=int, default=256, help="rows to run TFModel.transform on")
    parser.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                        help="device of each trainer and each inference executor")
    args = parser.parse_args(argv)

    from tensorflowonspark_tpu_torch import pipeline, util
    from tensorflowonspark_tpu_torch.backends import create_dataframe, get_spark_context
    from tensorflowonspark_tpu_torch.examples.mnist.mnist_data_setup import synthetic_mnist, to_rows

    images, labels = synthetic_mnist(args.num_examples)
    rows = to_rows(images, labels)

    # spark-submit / pyspark when present, local backend otherwise;
    # a caller-supplied sc is passed through with owned=False
    sc, args.cluster_size, owned = get_spark_context("mnist_pipeline", args.cluster_size, sc=sc,
                                                     local_default=1)
    try:
        df = create_dataframe(sc, rows, ["image", "label"], 8)
        est = (
            pipeline.TFEstimator(train_fun, vars(args), env={util.ENV_PLATFORM: args.platform})
            .setInputMapping({"image": "image", "label": "label"})
            .setBatchSize(args.batch_size)
            .setEpochs(args.epochs)
            .setClusterSize(args.cluster_size)
            .setExportDir(args.export_dir)
            .setGraceSecs(5)
        )
        model = est.fit(df)

        model.setInputMapping({"image": "image"}).setOutputMapping(
            {"prediction": "prediction", "device": "device"}
        ).setExportDir(args.export_dir)
        test_df = create_dataframe(sc, [(r[0],) for r in rows[:args.num_test]], ["image"], 4)
        out = model.transform(test_df).collect()
        # output columns in sorted tensor order: device, prediction
        devices = [r[0] for r in out]
        preds = [r[1] for r in out]
        acc = sum(int(p == labels[i]) for i, p in enumerate(preds)) / len(preds)
        print("pipeline inference accuracy on {} rows: {:.3f} (on {})".format(
            len(preds), acc, ", ".join(sorted(set(devices)))))
    finally:
        if owned:
            sc.stop()
    return preds, labels[:args.num_test].tolist(), devices


if __name__ == "__main__":
    from tensorflowonspark_tpu_torch import util

    util.setup_logging()
    main()
