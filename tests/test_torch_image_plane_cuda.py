"""The image real-data plane on a CUDA device. Marked ``cuda``: each test
skips without a card. This file imports neither jax nor the JAX package,
so it also runs on a card host that has only PyTorch (``python -m pytest
--noconftest -m cuda tests/test_torch_image_plane_cuda.py``).

* JPEG shards through the port's ``ImagePipeline`` (uint8) and
  ``loop_prefetch``, normalized on the card inside the captured train loop:
  the captured steps equal the eager steps bitwise (cuDNN deterministic).
* The feed autotuner's windows, placed through ``PinnedPlacer`` on the copy
  stream and fenced on their CUDA events, hold the host batches byte for
  byte, and the link estimate is measured (bandwidth and fixed cost > 0).
"""

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import tfrecord
from tensorflowonspark_tpu_torch.data import ImagePipeline, autotune, imagenet, loop_prefetch
from tensorflowonspark_tpu_torch.models import resnet
from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim

pytestmark = pytest.mark.cuda

RESNET = dict(stage_sizes=(1, 1), filters=(16, 32), num_classes=10, bottleneck=True, stem="imagenet")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and triton): run on the card")


def _shards(tmp_path, n=40):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "part-00000")
    with tfrecord.TFRecordWriter(path) as w:
        for i in range(n):
            w.write(imagenet.encode_example(rng.integers(0, 256, (48, 56, 3), dtype=np.uint8), i % 10))
    return [path]


def test_real_batches_through_the_captured_loop_equal_eager_steps(tmp_path, monkeypatch):
    _card()
    monkeypatch.delenv("TOS_DECODE_WORKERS", raising=False)
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        files = _shards(tmp_path)
        parse = imagenet.make_parse_fn(True, image_size=32, seed=0, raw_uint8=True)
        loss_fn = resnet.make_loss_fn(weight_decay=1e-4, normalize=imagenet.device_normalize)
        runs = []
        for k in (1, 5):
            strategy = SyncDataParallel("cuda")
            optimizer = optim.sgd(0.05, momentum=0.9)
            state = strategy.create_state(lambda: resnet.ResNet(
                dtype=torch.bfloat16, bn_impl="pallas", generator=torch.Generator().manual_seed(0), **RESNET),
                optimizer)
            stream = iter(ImagePipeline(files, parse, 8, seed=0, epochs=None))
            losses = []
            if k == 1:
                step = strategy.compile_train_step(loss_fn, optimizer, mutable=True)
                for window in loop_prefetch(stream, strategy, 5):
                    for batch in window:
                        state, metrics = step(state, batch)
                        losses.append(float(metrics["loss"]))
                    if len(losses) == 10:
                        break
            else:
                loop = strategy.compile_train_loop(loss_fn, optimizer, 5, mutable=True)
                for window in loop_prefetch(stream, strategy, 5):
                    state, metrics = loop(state, window)
                    losses.append(float(metrics["loss"]))
                    if len(losses) == 2:
                        break
            stream.close()
            runs.append((losses, {n: p.detach().clone() for n, p in state.module.named_parameters()}))
        (eager_losses, eager), (loop_losses, looped) = runs
        assert loop_losses == [eager_losses[4], eager_losses[9]]
        for name, value in eager.items():
            assert torch.equal(value, looped[name]), name
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def test_autotuned_windows_on_the_card_hold_the_host_batches():
    _card()
    strategy = SyncDataParallel("cuda")
    rng = np.random.default_rng(0)
    host = [{"image": rng.integers(0, 256, (16, 64, 64, 3), dtype=np.uint8),
             "label": rng.integers(0, 10, 16).astype(np.int32)} for _ in range(13)]
    tuner = autotune.FeedAutotuner(buckets=(1, 2, 4), reprobe_every=2)
    got = []
    for window in autotune.autotuned_prefetch(iter(host), strategy, tuner=tuner):
        assert window.k in tuner.buckets and window.data["image"].device.type == "cuda"
        got.extend({k: v[i].cpu().numpy() for k, v in window.data.items()} for i in range(window.k))
    assert len(got) == len(host)
    for g, h in zip(got, host):
        assert np.array_equal(g["image"], h["image"]) and np.array_equal(g["label"], h["label"])
    assert tuner.estimator.fixed_s > 0 and (tuner.estimator.bytes_per_sec or 0) > 0
