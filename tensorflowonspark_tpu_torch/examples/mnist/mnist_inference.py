"""Parallel single-node inference from an exported bundle through
TFParallel — the port of ``examples/mnist/mnist_inference.py``.

Each instance loads the bundle on its device (``ctx.device``: its share of
the host's cards, or the CPU with ``--platform cpu``), predicts its shard of
the test rows and writes ``part-<instance>`` lines of ``label prediction``
into ``--output``. TFParallel refuses more instances on a host than cards.

Usage::

    python -m tensorflowonspark_tpu_torch.examples.mnist.mnist_inference \\
        --export_dir /tmp/mnist_bundle --output /tmp/mnist_preds --cluster_size 1
"""

import argparse
import os


def inference_fun(args, ctx):
    import numpy as np

    from tensorflowonspark_tpu_torch.examples.mnist.mnist_data_setup import synthetic_mnist
    from tensorflowonspark_tpu_torch.train import export

    predict_fn, params, model_state = export.load_model(args.export_dir, device=ctx.device)
    images, labels = synthetic_mnist(args.num_examples, seed=99)
    # each instance handles its shard (reference ds.shard(num_workers, i))
    idx = np.arange(ctx.executor_id, len(labels), ctx.num_workers)

    os.makedirs(args.output, exist_ok=True)
    correct = total = 0
    devices = set()
    with open(os.path.join(args.output, "part-{:05d}".format(ctx.executor_id)), "w") as f:
        for start in range(0, len(idx), args.batch_size):
            chunk = idx[start : start + args.batch_size]
            out = predict_fn(params, model_state, {"image": images[chunk].reshape(len(chunk), -1)})
            preds = np.asarray(out["prediction"] if isinstance(out, dict) else out)[: len(chunk)]
            if isinstance(out, dict) and "device" in out:
                devices.update(np.asarray(out["device"]).tolist())
            for i, p in zip(chunk, preds):
                f.write("{} {}\n".format(labels[i], int(p)))
                correct += int(labels[i] == p)
                total += 1
    print("instance {}: {}/{} correct on {}".format(
        ctx.executor_id, correct, total, ", ".join(sorted(devices)) or ctx.device))


def main(argv=None, sc=None):
    """Run the example; returns the instance ids that completed."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--cluster_size", type=int, default=None,
                        help="explicit cluster size (default: from the Spark conf/parallelism under "
                             "Spark; 1 on the local backend)")
    parser.add_argument("--export_dir", required=True)
    parser.add_argument("--num_examples", type=int, default=2048)
    parser.add_argument("--output", required=True)
    parser.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                        help="device of each instance: its share of the host's cards, or the CPU")
    args = parser.parse_args(argv)

    from tensorflowonspark_tpu_torch import TFParallel, util
    from tensorflowonspark_tpu_torch.backends import get_spark_context

    # spark-submit / pyspark when present, local backend otherwise;
    # a caller-supplied sc is passed through with owned=False
    sc, args.cluster_size, owned = get_spark_context("mnist_inference", args.cluster_size, sc=sc,
                                                     local_default=1)
    try:
        done = TFParallel.run(sc, inference_fun, args, args.cluster_size,
                              env={util.ENV_PLATFORM: args.platform})
        print("inference shards in", args.output)
    finally:
        if owned:
            sc.stop()
    return done


def read_parts(output):
    """``[(label, prediction)]`` of every part file under ``output``."""
    pairs = []
    for name in sorted(os.listdir(output)):
        if name.startswith("part-"):
            with open(os.path.join(output, name)) as f:
                pairs.extend(tuple(int(v) for v in line.split()) for line in f if line.strip())
    return pairs


if __name__ == "__main__":
    from tensorflowonspark_tpu_torch import util

    util.setup_logging()
    main()
