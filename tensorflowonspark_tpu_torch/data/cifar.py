"""CIFAR-style record parsing and augmentation.

Capability-parity with the reference's examples/resnet/cifar_preprocessing.py
(:42-90 parse, :93-123 preprocess: pad-4 + random crop + flip for training,
per-image standardization always), numpy host-side.

Record schema (what :func:`encode_example` / dfutil write): ``image`` raw
uint8 HWC bytes (32x32x3), ``label`` int64 — a TFRecord-native layout rather
than the reference's legacy depth-major CIFAR binary.
"""

import numpy as np

from tensorflowonspark_tpu_torch import tfrecord

HEIGHT = 32
WIDTH = 32
NUM_CHANNELS = 3
NUM_CLASSES = 10
NUM_IMAGES = {"train": 50000, "validation": 10000}
_PAD = 4


def preprocess_train(image, rng):
    """uint8 HWC → float32: pad+random crop, random flip, standardize."""
    padded = np.pad(image, ((_PAD, _PAD), (_PAD, _PAD), (0, 0)), mode="constant")
    y = rng.integers(0, 2 * _PAD + 1)
    x = rng.integers(0, 2 * _PAD + 1)
    out = padded[y : y + HEIGHT, x : x + WIDTH]
    if rng.random() < 0.5:
        out = out[:, ::-1]
    return _standardize(out)


def preprocess_eval(image):
    return _standardize(image)


def _standardize(image):
    """Per-image standardization (the reference applies
    tf.image.per_image_standardization, cifar_preprocessing.py:121)."""
    img = np.asarray(image, np.float32)
    mean = img.mean()
    # stddev floored at 1/sqrt(N) like TF's adjusted_stddev
    adj = max(img.std(), 1.0 / np.sqrt(img.size))
    return (img - mean) / adj


def make_parse_fn(is_training, seed=0):
    """record bytes → (image f32 32x32x3, label int32). Augmentation rng is
    keyed to (seed, crc32 of the record) — deterministic under thread-pooled
    parsing (see imagenet.make_parse_fn)."""
    import zlib

    def parse(record):
        feats = tfrecord.decode_example(record)
        raw = feats["image"][1][0]
        image = np.frombuffer(raw, np.uint8).reshape(HEIGHT, WIDTH, NUM_CHANNELS)
        label = int(feats["label"][1][0])
        if is_training:
            rng = np.random.default_rng((seed << 32) ^ zlib.crc32(record))
            return preprocess_train(image, rng), label
        return preprocess_eval(image), label

    return parse


def encode_example(image_array, label):
    """uint8 HWC array + label → serialized Example (prep/test twin)."""
    arr = np.ascontiguousarray(np.asarray(image_array, np.uint8))
    return tfrecord.encode_example({"image": [arr.tobytes()], "label": [int(label)]})
