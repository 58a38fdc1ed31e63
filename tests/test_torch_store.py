"""The port's remote shard store and prefetch staging against the JAX
package: an ``http://`` corpus served in process (loopback only) lists,
stats and reads as the local files do, and the port's ``ImagePipeline``
over its URLs — cold ranged reads, staged prefetch (fixed and ``auto``),
warm — delivers the JAX package's local batches byte for byte; the text
plane does over HTTP too."""

import os

import numpy as np
import pytest
from torch_plane_util import serve_dir, stream, write_imagenet_shards

from tensorflowonspark_tpu import tfrecord as jax_tfrecord
from tensorflowonspark_tpu.data import ImagePipeline as JImagePipeline
from tensorflowonspark_tpu.data import TextPipeline as JTextPipeline
from tensorflowonspark_tpu.data import Tokenizer as JTokenizer
from tensorflowonspark_tpu.data import imagenet as jax_imagenet
from tensorflowonspark_tpu.store import http as jax_http
from tensorflowonspark_tpu_torch import obs
from tensorflowonspark_tpu_torch.data import ImagePipeline, TextPipeline, Tokenizer, imagenet, shard_files
from tensorflowonspark_tpu_torch.store import HTTPStore, LocalStore, resolve_store, staging


def _counter(name):
    return obs.snapshot()["counters"].get(name, {}).get("value", 0)


@pytest.fixture
def corpus(tmp_path, monkeypatch):
    """(local paths, their URLs) of a JPEG corpus served over HTTP, with a
    fresh staging root and no capacity bound."""
    for var in ("TOS_DECODE_WORKERS", "TOS_SLAB_CACHE_DIR", staging.BYTES_ENV, staging.DEPTH_ENV):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv(staging.DIR_ENV, str(tmp_path / "prefetch"))
    paths = write_imagenet_shards(tmp_path, n=36, shards=3, name="corpus")
    with serve_dir(tmp_path) as root:
        yield paths, [root + "/corpus/" + os.path.basename(p) for p in paths]


def _parses():
    kw = dict(image_size=16, seed=6, raw_uint8=True)
    return imagenet.make_parse_fn(True, **kw), jax_imagenet.make_parse_fn(True, **kw)


def test_http_store_lists_stats_and_reads_like_the_local_files(corpus):
    paths, urls = corpus
    store = HTTPStore(range_bytes=4096)
    assert store.handles(urls[0]) and not store.handles(paths[0])
    assert store.list_shards(os.path.dirname(urls[0]) + "/") == urls
    for p, u in zip(paths, urls):
        assert store.stat(u)["size"] == os.path.getsize(p)
        want = list(jax_tfrecord.read_records(p))
        assert [r for chunk in store.read_records_chunked(u, chunk_records=5) for r in chunk] == want
        assert list(LocalStore().read_records(p)) == want
    assert isinstance(resolve_store(urls), HTTPStore)
    assert type(resolve_store(urls)).__name__ == type(jax_http.resolve_store(urls)).__name__
    # per-worker shard assignment orders URLs as it orders the local paths
    assert [os.path.basename(u) for u in shard_files(urls, 2, 1)] == [
        os.path.basename(p) for p in shard_files(paths, 2, 1)]


@pytest.mark.parametrize("prefetch", ["0", "2", "auto"], ids=["cold", "staged", "staged_auto"])
def test_image_stream_over_http_is_the_jax_packages_local_stream(corpus, prefetch):
    paths, urls = corpus
    parse, jparse = _parses()
    kw = dict(batch_size=4, seed=3, epochs=2, num_threads=2)
    want = stream(JImagePipeline(paths, jparse, decode_workers=0, **kw))
    commits = _counter("store_prefetch_commits_total")
    reads = _counter("store_remote_reads_total")
    pipe = ImagePipeline(urls, parse, prefetch=prefetch, **kw)
    assert isinstance(pipe.store, HTTPStore)  # http(s):// shards pick the store
    assert stream(pipe) == want
    assert _counter("store_remote_reads_total") > reads
    if prefetch != "0":
        assert _counter("store_prefetch_commits_total") > commits
        hits = _counter("store_prefetch_hits_total")
        assert stream(ImagePipeline(urls, parse, prefetch=prefetch, **kw)) == want  # warm
        assert _counter("store_prefetch_hits_total") > hits


def test_explicit_store_with_the_decode_plane(corpus):
    paths, urls = corpus
    parse, jparse = _parses()
    kw = dict(batch_size=4, seed=1, epochs=1)
    want = stream(JImagePipeline(paths, jparse, decode_workers=0, **kw))
    assert stream(ImagePipeline(urls, parse, store=HTTPStore(range_bytes=2048), prefetch="0",
                                decode_workers=2, **kw)) == want


def test_text_stream_over_http_is_the_jax_packages(tmp_path, monkeypatch):
    monkeypatch.setenv(staging.DIR_ENV, str(tmp_path / "prefetch"))
    rng = np.random.default_rng(11)
    words = "remote shard store streams packed text identically".split()
    d = tmp_path / "text"
    d.mkdir()
    paths = []
    for s in range(2):
        p = str(d / "part-{:05d}".format(s))
        with jax_tfrecord.TFRecordWriter(p) as w:
            for _ in range(45):
                w.write(" ".join(rng.choice(words, size=int(rng.integers(2, 12)))).encode())
        paths.append(p)
    common = dict(seq_len=48, batch_size=4, seed=7, epochs=2)
    want = list(JTextPipeline(paths, JTokenizer(kind="word", vocab_size=128), **common))
    with serve_dir(tmp_path) as root:
        urls = [root + "/text/" + os.path.basename(p) for p in paths]
        for prefetch in ("0", "2"):
            got = list(TextPipeline(urls, Tokenizer(kind="word", vocab_size=128), prefetch=prefetch, **common))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                for k in ("tokens", "segment_ids", "positions"):
                    assert np.array_equal(np.asarray(g[k]), np.asarray(w[k])), k


def test_stager_knobs_resolve_as_in_the_jax_package(tmp_path, monkeypatch):
    monkeypatch.setenv(staging.DIR_ENV, str(tmp_path / "p"))
    store = LocalStore()
    assert staging.resolve_stager(store, prefetch="0") is None
    fixed = staging.resolve_stager(store, prefetch="3")
    auto = staging.resolve_stager(store, prefetch="auto")
    try:
        assert fixed.depth == 3 and fixed._tuner is None and auto._tuner is not None
    finally:
        fixed.close()
        auto.close()
