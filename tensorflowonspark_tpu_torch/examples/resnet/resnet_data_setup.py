"""Write CIFAR/ImageNet-schema TFRecord shards for resnet_spark.py — the
port of ``examples/resnet/resnet_data_setup.py``, writing with the port's
``tfrecord`` and ``encode_example`` (the same bytes).

The reference assumed pre-existing TFRecords (imagenet_preprocessing.py:144
get_filenames over train-xxxxx-of-01024) and shipped a separate download
pipeline; this tool writes shards in the SAME schema from synthetic images
(uniform random pixels from ``--seed``), or from numpy .npz files via
--from_npz with arrays ``images`` uint8 NHWC and ``labels``, exercising the
identical read path. ImageNet records are JPEG (PIL, quality 90).

Usage:
    python -m tensorflowonspark_tpu_torch.examples.resnet.resnet_data_setup \
        --output /tmp/imagenet_tfr --dataset imagenet --image_size 256 \
        --num_examples 2048 --num_shards 8
"""

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", choices=["cifar", "imagenet"], default="cifar")
    parser.add_argument("--from_npz", default=None)
    parser.add_argument("--image_size", type=int, default=None)
    parser.add_argument("--num_examples", type=int, default=1024)
    parser.add_argument("--num_shards", type=int, default=4)
    parser.add_argument("--output", required=True)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import numpy as np

    from tensorflowonspark_tpu_torch import tfrecord
    from tensorflowonspark_tpu_torch.data import cifar, imagenet

    if args.dataset == "cifar":
        encode, classes = cifar.encode_example, cifar.NUM_CLASSES
        size = args.image_size or cifar.HEIGHT
    else:
        encode, classes = imagenet.encode_example, imagenet.NUM_CLASSES
        size = args.image_size or imagenet.IMAGE_SIZE

    if args.from_npz:
        data = np.load(args.from_npz)
        images, labels = data["images"], data["labels"]
    else:
        rng = np.random.default_rng(args.seed)
        images = rng.integers(0, 256, (args.num_examples, size, size, 3), dtype=np.uint8)
        labels = rng.integers(0, classes, args.num_examples)

    os.makedirs(args.output, exist_ok=True)
    per = (len(images) + args.num_shards - 1) // args.num_shards
    total = 0
    for s in range(args.num_shards):
        lo, hi = s * per, min((s + 1) * per, len(images))
        path = os.path.join(args.output, "part-{:05d}".format(s))
        with tfrecord.TFRecordWriter(path) as w:
            for i in range(lo, hi):
                w.write(encode(images[i], int(labels[i])))
                total += 1
    print("wrote {} examples in {} shards to {}".format(total, args.num_shards, args.output))


if __name__ == "__main__":
    from tensorflowonspark_tpu_torch import util

    util.setup_logging()
    main()
