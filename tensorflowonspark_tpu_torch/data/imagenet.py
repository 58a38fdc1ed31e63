"""ImageNet-style record parsing and augmentation (PIL + numpy, and the
native decoder), copied from the JAX package's ``data/imagenet.py``; the
on-device normalisation is the port's torch version.

Capability-parity with the reference's pipeline
(``examples/resnet/imagenet_preprocessing.py``: record schema :156-223,
distorted-bbox crop+flip :326-373, aspect-preserving resize + central crop
for eval :375-501, channel-mean subtraction :397-430), built host-side
without TensorFlow: decode and resize ride PIL's C codecs (or the port's
native decoder, :mod:`~tensorflowonspark_tpu_torch.native_io`) on the
executor's CPUs; the device never sees a dynamic shape.

Record schema (the de-facto ImageNet TFRecord layout the reference parses):
``image/encoded`` JPEG bytes, ``image/class/label`` int64.
"""

import io
import logging

import numpy as np

from tensorflowonspark_tpu_torch import tfrecord

logger = logging.getLogger(__name__)

IMAGE_SIZE = 224
#: standard per-channel RGB means (same constants the reference subtracts,
#: imagenet_preprocessing.py:54-57)
CHANNEL_MEANS = np.array([123.68, 116.78, 103.94], np.float32)
#: eval-time aspect-preserving resize target for the short side
RESIZE_MIN = 256

NUM_CLASSES = 1000
NUM_IMAGES = {"train": 1281167, "validation": 50000}


def _decode(image_bytes):
    from PIL import Image

    img = Image.open(io.BytesIO(image_bytes))
    if img.mode != "RGB":
        img = img.convert("RGB")
    return img


def _random_crop_box(width, height, rng, area_range=(0.05, 1.0), aspect_range=(0.75, 1.33), attempts=10):
    """Inception-style distorted bounding box: sample a crop whose area and
    aspect ratio fall in the given ranges; fall back to a central square
    (the reference's sample_distorted_bounding_box fallback,
    imagenet_preprocessing.py:326-373)."""
    area = width * height
    for _ in range(attempts):
        target_area = rng.uniform(*area_range) * area
        aspect = rng.uniform(*aspect_range)
        w = int(round(np.sqrt(target_area * aspect)))
        h = int(round(np.sqrt(target_area / aspect)))
        if w <= width and h <= height and w > 0 and h > 0:
            x = rng.integers(0, width - w + 1)
            y = rng.integers(0, height - h + 1)
            return x, y, w, h
    side = min(width, height)
    return (width - side) // 2, (height - side) // 2, side, side


def preprocess_train(image_bytes, rng, image_size=IMAGE_SIZE, raw_uint8=False):
    """JPEG bytes → float32 HWC: distorted crop, resize, random flip, mean
    subtract. ``raw_uint8=True`` skips the mean subtraction and returns the
    uint8 pixels — quarter the feed bytes; normalize on device with
    :func:`device_normalize`."""
    from PIL import Image

    img = _decode(image_bytes)
    x, y, w, h = _random_crop_box(img.width, img.height, rng)
    img = img.resize((image_size, image_size), Image.BILINEAR, box=(x, y, x + w, y + h))
    arr = np.asarray(img)
    if rng.random() < 0.5:
        arr = arr[:, ::-1]
    if raw_uint8:
        return np.ascontiguousarray(arr)
    return arr.astype(np.float32) - CHANNEL_MEANS


def preprocess_eval(image_bytes, image_size=IMAGE_SIZE, resize_min=RESIZE_MIN, raw_uint8=False):
    """JPEG bytes → float32 HWC: aspect-preserving resize, central crop, mean
    subtract (imagenet_preprocessing.py:375-501)."""
    from PIL import Image

    img = _decode(image_bytes)
    scale = resize_min / min(img.width, img.height)
    nw, nh = int(round(img.width * scale)), int(round(img.height * scale))
    img = img.resize((nw, nh), Image.BILINEAR)
    x = (nw - image_size) // 2
    y = (nh - image_size) // 2
    arr = np.asarray(img.crop((x, y, x + image_size, y + image_size)))
    if raw_uint8:
        return arr
    return arr.astype(np.float32) - CHANNEL_MEANS


_DEVICE_MEANS = {}  # device -> CHANNEL_MEANS there


def device_normalize(images):
    """On-device twin of the host mean subtraction: uint8 ``[B,H,W,C]``
    tensor → float32 minus :data:`CHANNEL_MEANS`, so the feed can ship
    uint8 (a quarter of the float32 bytes) to the device. The means are
    copied to a device once, on the first (eager) call there: a captured
    train step reads that tensor and makes no host copy."""
    import torch

    means = _DEVICE_MEANS.get(images.device)
    if means is None:
        means = _DEVICE_MEANS[images.device] = torch.as_tensor(CHANNEL_MEANS, device=images.device)
    return images.float() - means


def make_parse_fn(is_training, image_size=IMAGE_SIZE, label_offset=0, seed=0, raw_uint8=False):
    """record bytes → (image f32 HWC, label int32).

    ``label_offset`` handles 1-based ImageNet labels (pass -1 to map 1..1000
    onto 0..999). The augmentation rng is keyed to (seed, crc32 of the record
    bytes) so a seeded run applies identical crops/flips to each image no
    matter how the thread pool schedules the parses. ``raw_uint8=True``
    keeps images uint8 and un-normalized for the slim feed path (pair with
    :func:`device_normalize` on device).

    Decode-plane contract: the returned closure must work after a fork —
    it captures only plain values (no locks, threads or open handles) and
    lives at module level, so ``ImagePipeline(decode_workers=N)`` can run
    it inside worker processes. Keep custom ``parse_fn`` replacements to
    the same shape: fork-inheritable state only, deterministic per record
    bytes (the record-keyed rng above), since a chaos-killed worker's slot
    may be decoded twice and both decodes must write identical pixels.
    """
    import zlib

    def parse(record):
        feats = tfrecord.decode_example(record)
        image_bytes = feats["image/encoded"][1][0]
        label = int(feats["image/class/label"][1][0]) + label_offset
        if is_training:
            rng = np.random.default_rng((seed << 32) ^ zlib.crc32(record))
            image = preprocess_train(image_bytes, rng, image_size, raw_uint8=raw_uint8)
        else:
            image = preprocess_eval(image_bytes, image_size, raw_uint8=raw_uint8)
        return image, label

    def into(record, out):
        """record bytes → pixels written directly into ``out`` (a uint8
        ``(image_size, image_size, 3)`` view of a shared-memory slab slot).

        The native fast path: one C call decodes the JPEG and lands the
        Pillow-exact crop/resize/flip in ``out`` — no PIL, no intermediate
        copy. The augmentation rng is keyed and *drawn* in exactly
        :func:`preprocess_train`'s order (crop-box draws, then the flip
        draw), so native and PIL modes produce byte-identical streams.
        Returns ``(label, used_native)``; any native failure — library
        absent, unsupported coding, corrupt stream — falls back to the full
        PIL parse, so a record is charged against ``max_bad_records``
        exactly when PIL itself cannot decode it.
        """
        from tensorflowonspark_tpu_torch import native_io

        feats = tfrecord.decode_example(record)
        image_bytes = feats["image/encoded"][1][0]
        label = int(feats["image/class/label"][1][0]) + label_offset
        if native_io.jpg_available():
            try:
                width, height = native_io.jpg_info(image_bytes)
                if is_training:
                    rng = np.random.default_rng((seed << 32) ^ zlib.crc32(record))
                    x, y, w, h = _random_crop_box(width, height, rng)
                    flip = rng.random() < 0.5
                    native_io.jpg_decode_window(
                        image_bytes, out, (x, y, x + w, y + h),
                        (image_size, image_size), flip=flip)
                else:
                    scale = RESIZE_MIN / min(width, height)
                    nw, nh = int(round(width * scale)), int(round(height * scale))
                    ox, oy = (nw - image_size) // 2, (nh - image_size) // 2
                    if ox < 0 or oy < 0:
                        raise native_io.JpegError("image smaller than crop")
                    native_io.jpg_decode_window(
                        image_bytes, out, (0, 0, width, height), (nw, nh),
                        window_origin=(ox, oy))
                return label, True
            except (native_io.JpegError, RuntimeError):
                pass  # PIL below is both oracle and fallback
        image, label = parse(record)
        out[...] = image
        return label, False

    if raw_uint8:
        # the native into-slab path produces uint8 pixels only; float32
        # parses (mean-subtracted) keep the plain PIL closure
        parse.into = into
    #: decode-parameter fingerprint: keys the cross-epoch decoded-slab cache
    #: (same bytes + same key ⇒ same pixels, in every decode mode)
    parse.cache_key = "imagenet:v1:{}:{}:{}:{}:{}".format(
        "train" if is_training else "eval", image_size, label_offset, seed,
        int(bool(raw_uint8)))
    return parse


def encode_example(image_array, label, quality=90):
    """uint8 HWC array + label → serialized Example with JPEG bytes (for
    dataset prep and tests; the write-side twin of :func:`make_parse_fn`).
    Encodes with PIL (baseline JPEG, PIL's default 4:2:0 subsampling)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.asarray(image_array, np.uint8)).save(buf, "JPEG", quality=quality)
    return tfrecord.encode_example(
        {"image/encoded": [buf.getvalue()], "image/class/label": [int(label)]}
    )
