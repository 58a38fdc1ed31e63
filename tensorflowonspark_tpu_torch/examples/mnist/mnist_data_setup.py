"""Prepare MNIST data as CSV-style rows or TFRecords — the port of
``examples/mnist/mnist_data_setup.py``.

``--source synthetic`` (the default) generates a deterministic MNIST-shaped
dataset, byte for byte the JAX example's, so nothing needs a download;
``--source tfds`` uses tensorflow_datasets when it is installed. TFRecords
are written through the port's ``dfutil`` and ``tfrecord``.

Usage (local backend)::

    python -m tensorflowonspark_tpu_torch.examples.mnist.mnist_data_setup \\
        --output /tmp/mnist --format tfrecords
"""

import argparse
import os


def synthetic_mnist(num_examples=10000, seed=0):
    """Deterministic MNIST-shaped data: class-dependent blob patterns so
    models can actually learn (test accuracy is meaningful, not 10%).
    ``(images float32 [N, 28, 28] in [0, 1], labels int64 [N])``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, num_examples)
    images = rng.normal(0.1, 0.05, (num_examples, 28, 28)).astype(np.float32)
    for digit in range(10):
        mask = labels == digit
        r, c = 4 + 2 * (digit % 5), 6 + 3 * (digit // 5)
        images[mask, r : r + 6, c : c + 6] += 0.8
    return np.clip(images, 0, 1), labels.astype(np.int64)


def to_rows(images, labels):
    """The feed's row format: ``(image as a list of 784 floats, label)``."""
    flat = images.reshape(len(labels), -1).tolist()
    return [(flat[i], int(labels[i])) for i in range(len(labels))]


def main(argv=None, sc=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--output", required=True, help="output directory")
    parser.add_argument("--format", choices=["tfrecords", "csv"], default="tfrecords")
    parser.add_argument("--source", choices=["synthetic", "tfds"], default="synthetic")
    parser.add_argument("--num_examples", type=int, default=10000)
    parser.add_argument("--num_partitions", type=int, default=4)
    args = parser.parse_args(argv)

    import numpy as np

    if args.source == "tfds":
        import tensorflow_datasets as tfds

        ds = tfds.as_numpy(tfds.load("mnist", split="train", batch_size=-1))
        images = ds["image"].reshape(-1, 28, 28).astype(np.float32) / 255.0
        labels = ds["label"].astype(np.int64)
    else:
        images, labels = synthetic_mnist(args.num_examples)

    from tensorflowonspark_tpu_torch import dfutil
    from tensorflowonspark_tpu_torch.backends import create_dataframe, get_spark_context

    sc, _n, owned = get_spark_context("mnist_data_setup", 2, sc=sc)
    try:
        rows = to_rows(images, labels)
        if args.format == "tfrecords":
            df = create_dataframe(sc, rows, ["image", "label"], args.num_partitions)
            dfutil.saveAsTFRecords(df, args.output)
        else:
            os.makedirs(args.output, exist_ok=True)
            with open(os.path.join(args.output, "mnist.csv"), "w") as f:
                for img, lbl in rows:
                    f.write(",".join(str(x) for x in img) + "|" + str(lbl) + "\n")
        print("wrote {} examples to {}".format(len(rows), args.output))
    finally:
        if owned:
            sc.stop()


if __name__ == "__main__":
    from tensorflowonspark_tpu_torch import util

    util.setup_logging()
    main()
