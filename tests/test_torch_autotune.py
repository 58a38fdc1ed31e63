"""The port's autotuners against the JAX package's: the same observations
and counter deltas give the same estimates and the same decisions
(``LinkEstimator``, ``FeedAutotuner``, ``ReadaheadAutotuner``,
``DecodeAutotuner``); the feed autotuner's windows, placed through
``PinnedPlacer.place(..., stacked=True)``, deliver the source batches byte
for byte for any bucket set; and ``readahead="auto"`` leaves the stream the
JAX package's."""

import numpy as np
import pytest
import torch
from torch_plane_util import stream, write_imagenet_shards

from tensorflowonspark_tpu.data import ImagePipeline as JImagePipeline
from tensorflowonspark_tpu.data import autotune as jax_autotune
from tensorflowonspark_tpu.data import decode_plane as jax_decode_plane
from tensorflowonspark_tpu.data import imagenet as jax_imagenet
from tensorflowonspark_tpu_torch import chaos
from tensorflowonspark_tpu_torch.data import ImagePipeline, autotune, decode_plane, imagenet
from tensorflowonspark_tpu_torch.train import SyncDataParallel


def _deltas(seed, n=60):
    """Seeded interval readings ``(read, parse, wait, elapsed)`` that visit
    the starved/io-bound, starved/decode-bound, busy and idle verdicts."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        elapsed = float(rng.uniform(0.5, 3.0))
        wait = float(elapsed * rng.choice([0.0, 0.005, 0.03, 0.2, 0.6]))
        out.append((float(rng.uniform(0, 2)), float(rng.uniform(0, 2)), wait, elapsed))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_readahead_autotuner_decides_as_the_jax_package(seed):
    kw = dict(min_depth=1, max_depth=6, down_patience=2)
    port, jax = autotune.ReadaheadAutotuner(**kw), jax_autotune.ReadaheadAutotuner(**kw)
    depth_p = depth_j = 2
    trajectory = []
    for read, parse, wait, elapsed in _deltas(seed):
        depth_p = port.decide(depth_p, read, parse, wait, elapsed)
        depth_j = jax.decide(depth_j, read, parse, wait, elapsed)
        assert depth_p == depth_j
        trajectory.append(depth_p)
    assert len(set(trajectory)) > 1  # the sequence moved the depth


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_autotuner_decides_as_the_jax_package(seed):
    kw = dict(min_workers=1, max_workers=8, down_patience=2)
    port, jax = decode_plane.DecodeAutotuner(**kw), jax_decode_plane.DecodeAutotuner(**kw)
    workers_p = workers_j = 3
    trajectory = []
    for _, parse, wait, elapsed in _deltas(seed + 10):
        workers_p = port.decide(workers_p, parse, wait, elapsed)
        workers_j = jax.decide(workers_j, parse, wait, elapsed)
        assert workers_p == workers_j
        trajectory.append(workers_p)
    assert len(set(trajectory)) > 1


def test_tickers_read_the_same_counter_deltas_on_a_clock():
    """The clocked wrappers gate on ``check_every`` and read injected
    counters the same way in both packages."""
    now = [0.0]
    values = [(0.0, 0.0, 0.0), (1.5, 0.2, 0.8), (1.5, 0.2, 0.8), (3.0, 0.4, 0.8)] * 2

    def make(pkg):
        it = iter(values)
        return pkg.ReadaheadAutotuner(check_every=1.0, clock=lambda: now[0], read_counters=lambda: next(it),
                                      gauge=_NullGauge())

    port, jax = make(autotune), make(jax_autotune)
    for t in (0.0, 0.5, 1.2, 1.3, 2.5, 3.9):
        now[0] = t
        assert port.tick(3) == jax.tick(3)


class _NullGauge:
    def set(self, value):
        pass


def _feed_observations(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        kind = rng.choice(["probe", "transfer", "decide"])
        out.append((kind, float(rng.choice([5e-4, 0.02, 0.3])) * float(rng.uniform(0.5, 1.5)),
                    int(rng.choice([1e5, 1e6, 8e6]))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_feed_autotuner_estimates_and_decides_as_the_jax_package(seed):
    kw = dict(buckets=(1, 2, 4, 8, 16), alpha=0.5, down_patience=2)
    port, jax = autotune.FeedAutotuner(**kw), jax_autotune.FeedAutotuner(**kw)
    batch = 1_000_000
    for kind, seconds, nbytes in _feed_observations(seed):
        if kind == "probe":
            port.note_fixed_probe(seconds)
            jax.note_fixed_probe(seconds)
        elif kind == "transfer":
            port.note_transfer(nbytes, seconds + nbytes / 5e8)
            jax.note_transfer(nbytes, seconds + nbytes / 5e8)
        else:
            assert port.decide(batch) == jax.decide(batch)
        assert (port.estimator.fixed_s, port.estimator.bytes_per_sec) == (
            jax.estimator.fixed_s, jax.estimator.bytes_per_sec)
        assert port.recommend(batch) == jax.recommend(batch)


def test_link_estimator_and_bucket_decomposition_match():
    port, jax = autotune.LinkEstimator(alpha=0.3), jax_autotune.LinkEstimator(alpha=0.3)
    for f, (b, s) in zip([0.01, 0.2, 0.004], [(1e6, 0.05), (4e6, 0.001), (2e6, 0.3)]):
        port.observe_fixed(f), jax.observe_fixed(f)
        port.observe(b, s), jax.observe(b, s)
        assert port.predict(3e6) == jax.predict(3e6) and port.fixed_share(3e6) == jax.fixed_share(3e6)
    for n in range(0, 40):
        assert autotune.bucket_decomposition(n, (1, 2, 4, 8, 16)) == jax_autotune.bucket_decomposition(
            n, (1, 2, 4, 8, 16))


def test_batch_nbytes_counts_every_array_as_the_jax_package():
    batch = {"x": np.zeros((8, 3), np.float32), "y": [np.ones(5, np.int64), (np.ones((2, 2), np.uint8),)]}
    assert autotune.batch_nbytes(batch) == jax_autotune.batch_nbytes(batch) == 96 + 40 + 4


def _xy_batches(n, rows=8):
    rng = np.random.default_rng(0)
    return [{"x": rng.standard_normal((rows, 2)).astype(np.float32),
             "y": rng.standard_normal((rows, 1)).astype(np.float32)} for _ in range(n)]


def _delivered(host, tuner):
    strategy = SyncDataParallel(torch.device("cpu"))
    out, ks = [], []
    for w in autotune.autotuned_prefetch(iter(host), strategy, tuner=tuner):
        assert w.k in tuner.buckets
        ks.append(w.k)
        for i in range(w.k):
            out.append({k: v[i].numpy() for k, v in w.data.items()})
    return out, ks


@pytest.mark.parametrize("n", [1, 7, 11, 16])
def test_autotuned_windows_deliver_the_source_batches_for_any_bucket_set(n):
    host = _xy_batches(n)
    for buckets in [(1,), (1, 2), (1, 4), (1, 2, 4, 8, 16)]:
        got, ks = _delivered(host, autotune.FeedAutotuner(buckets=buckets))
        assert sum(ks) == n == len(got)
        for a, b in zip(got, host):
            for key in ("x", "y"):
                np.testing.assert_array_equal(a[key], b[key])


def test_injected_link_latency_moves_the_window_to_the_top_bucket(monkeypatch):
    """``data.device_link`` sleeps inside the timed placement (probes and
    windows): at 60 ms a transfer the fixed-cost share is near 1 at every
    bucket, so the controller climbs to the top bucket, and the delivery
    stays byte for byte.

    The tuner's clock is this thread's CPU time plus the injected sleeps:
    the link's cost as the test defines it. A wall clock also reads the
    host's scheduler stalls, and under a loaded host one stalled 1 MB
    window reads as a slow stream that argues for a smaller bucket."""
    import time
    import types

    slept = [0.0]

    def sleep(seconds):
        slept[0] += seconds
        time.sleep(seconds)

    monkeypatch.setattr(autotune, "time", types.SimpleNamespace(sleep=sleep, perf_counter=time.perf_counter))
    plan = chaos.ChaosPlan(seed=0).site("data.device_link", probability=1.0, delay_s=0.06)
    chaos.install(plan, propagate=False)
    try:
        host = [{"x": np.full((8, 128, 256), i, np.float32)} for i in range(10)]
        tuner = autotune.FeedAutotuner(buckets=(1, 2, 4), alpha=0.7, reprobe_every=1, down_patience=1,
                                       clock=lambda: time.thread_time() + slept[0])
        got, ks = _delivered(host, tuner)
    finally:
        chaos.uninstall()
    assert plan.fired("data.device_link") > 0 and slept[0] >= 0.06 * plan.fired("data.device_link")
    assert max(ks) == 4 and sum(ks) == 10
    for i, batch in enumerate(got):
        np.testing.assert_array_equal(batch["x"], host[i]["x"])


def test_readahead_auto_stream_is_the_jax_packages(tmp_path, monkeypatch):
    monkeypatch.delenv("TOS_DECODE_WORKERS", raising=False)
    files = write_imagenet_shards(tmp_path, n=24, shards=3)
    kw = dict(batch_size=4, seed=3, epochs=1, chunk_records=4)
    parse = imagenet.make_parse_fn(True, image_size=16, seed=1, raw_uint8=True)
    jparse = jax_imagenet.make_parse_fn(True, image_size=16, seed=1, raw_uint8=True)
    want = stream(JImagePipeline(files, jparse, readahead=2, decode_workers=0, **kw))
    assert stream(ImagePipeline(files, parse, readahead="auto", decode_workers=0, **kw)) == want
