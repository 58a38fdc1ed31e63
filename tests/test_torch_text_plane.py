"""The port's copied text plane against the JAX package's: the same small
corpus, tokenizer and seed give byte-identical packed rows (``tokens``,
``segment_ids``, ``positions``), and the example's synthetic corpus is the
same bytes from both packages' writers."""

import importlib.util
import os

import numpy as np
import pytest

from tensorflowonspark_tpu.data import TextPipeline as JTextPipeline
from tensorflowonspark_tpu.data import Tokenizer as JTokenizer
from tensorflowonspark_tpu_torch import tfrecord
from tensorflowonspark_tpu_torch.data import ImagePipeline, TextPipeline, Tokenizer, shard_files
from tensorflowonspark_tpu_torch.examples.transformer import transformer_spark

KEYS = ("tokens", "segment_ids", "positions")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _corpus(tmp_path, n=150, shards=3, seed=0):
    rng = np.random.default_rng(seed)
    words = "spark text plane packs variable length sequences tightly".split()
    per = -(-n // shards)
    paths = []
    for s in range(shards):
        path = str(tmp_path / "part-{:05d}".format(s))
        with tfrecord.TFRecordWriter(path) as w:
            for _ in range(per):
                w.write(" ".join(rng.choice(words, size=max(2, int(rng.lognormal(2.2, 0.7))))).encode())
        paths.append(path)
    return paths


def _rows(pipe, n_batches=None):
    out = []
    for batch in pipe:
        out.append({k: np.array(batch[k]) for k in KEYS})
        if n_batches and len(out) == n_batches:
            break
    return out


@pytest.mark.parametrize("kind, seq_len, batch_size, shuffle", [
    ("byte", 65, 4, True),
    ("byte", 129, 2, False),
    ("word", 33, 3, True),
])
def test_text_pipeline_rows_are_byte_identical(tmp_path, kind, seq_len, batch_size, shuffle):
    files = _corpus(tmp_path)
    common = dict(seq_len=seq_len, batch_size=batch_size, shuffle=shuffle, seed=3, epochs=1,
                  pack_workers=0)
    vocab = 512 if kind == "word" else None
    got = _rows(TextPipeline(files, Tokenizer(kind=kind, vocab_size=vocab), **common))
    want = _rows(JTextPipeline(files, JTokenizer(kind=kind, vocab_size=vocab), **common))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in KEYS:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def test_endless_stream_and_shard_split_match(tmp_path):
    """``epochs=None`` (the trainer's setting) across an epoch boundary,
    on one worker's ``shard_files`` share."""
    files = shard_files(_corpus(tmp_path), 2, 1)
    common = dict(seq_len=257, batch_size=2, seed=1, epochs=None, pack_workers=0)
    got = _rows(TextPipeline(files, Tokenizer(kind="byte"), **common), n_batches=12)
    want = _rows(JTextPipeline(files, JTokenizer(kind="byte"), **common), n_batches=12)
    for g, w in zip(got, want):
        for k in KEYS:
            assert np.array_equal(g[k], w[k]), k


def test_synthetic_corpus_is_the_jax_examples(tmp_path):
    """The port's ``make_text_corpus`` writes the JAX example's bytes."""
    spec = importlib.util.spec_from_file_location(
        "jax_transformer_spark", os.path.join(REPO, "examples", "transformer", "transformer_spark.py"))
    jexample = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jexample)
    got = transformer_spark.make_text_corpus(str(tmp_path / "port"), num_shards=2, records_per_shard=20)
    want = jexample.make_text_corpus(str(tmp_path / "jax"), num_shards=2, records_per_shard=20)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == [
        "part-00000", "part-00001"]
    for g, w in zip(got, want):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read()


def test_python_crc32c_writes_the_same_shards(tmp_path, monkeypatch):
    """Without ``google_crc32c`` (a GPU host may lack it) the port's
    table-driven crc32c frames the same bytes."""
    from tensorflowonspark_tpu_torch.store import framing

    want = transformer_spark.make_text_corpus(str(tmp_path / "lib"), num_shards=1, records_per_shard=30)
    monkeypatch.setattr(framing, "google_crc32c", None)
    monkeypatch.setattr(framing, "_native_masked", [None])  # the Python loop, not the native library
    assert framing.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    got = transformer_spark.make_text_corpus(str(tmp_path / "py"), num_shards=1, records_per_shard=30)
    with open(got[0], "rb") as fg, open(want[0], "rb") as fw:
        assert fg.read() == fw.read()


def _image_corpus(tmp_path, n=12):
    from tensorflowonspark_tpu.data import imagenet as jax_imagenet

    rng = np.random.default_rng(0)
    os.makedirs(tmp_path / "img")
    path = str(tmp_path / "img" / "part-00000")
    with tfrecord.TFRecordWriter(path) as w:
        for i in range(n):
            w.write(jax_imagenet.encode_example(rng.integers(0, 256, (30, 34, 3), dtype=np.uint8), i))
    return [path]


def _image_parses():
    from tensorflowonspark_tpu.data import imagenet as jax_imagenet
    from tensorflowonspark_tpu_torch.data import imagenet

    kw = dict(image_size=16, seed=2, raw_uint8=True)
    return imagenet.make_parse_fn(True, **kw), jax_imagenet.make_parse_fn(True, **kw)


def _image_stream(pipe):
    return [(np.asarray(b["image"]).tobytes(), np.asarray(b["label"]).tobytes()) for b in pipe]


@pytest.mark.parametrize("option", ["pack_workers", "slab_cache", "decode_workers", "store", "prefetch",
                                    "readahead_auto", "http_shards"])
def test_lifted_pipeline_options_run(tmp_path, monkeypatch, option):
    """The options the port refused until the image-plane slice run now and
    deliver the JAX package's stream: the forked pack and decode planes, the
    packed-slab cache, an explicit store, prefetch staging, the read-ahead
    autotuner and ``http://`` shards (served in process, loopback only)."""
    from tensorflowonspark_tpu.data import ImagePipeline as JImagePipeline
    from tensorflowonspark_tpu_torch.store import HTTPStore, LocalStore, staging
    from torch_plane_util import serve_dir

    monkeypatch.delenv("TOS_DECODE_WORKERS", raising=False)
    monkeypatch.setenv(staging.DIR_ENV, str(tmp_path / "prefetch"))
    if option in ("pack_workers", "slab_cache"):
        files = _corpus(tmp_path, n=30, shards=2)
        common = dict(seq_len=65, batch_size=2, seed=1, epochs=1)
        want = _rows(JTextPipeline(files, JTokenizer(kind="byte"), **common))
        extra = {"pack_workers": 2} if option == "pack_workers" else {"slab_cache_dir": str(tmp_path / "c")}
        for _ in range(1 if option == "pack_workers" else 2):  # the cache cold, then warm
            got = _rows(TextPipeline(files, Tokenizer(kind="byte"), **common, **extra))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                for k in KEYS:
                    assert np.array_equal(g[k], w[k]), k
        return
    files = _image_corpus(tmp_path)
    parse, jparse = _image_parses()
    common = dict(batch_size=4, seed=2, epochs=1)
    want = _image_stream(JImagePipeline(files, jparse, decode_workers=0, **common))
    if option in ("decode_workers", "readahead_auto"):
        kw = {"decode_workers": 2} if option == "decode_workers" else {"readahead": "auto"}
        assert _image_stream(ImagePipeline(files, parse, **kw, **common)) == want
        return
    with serve_dir(tmp_path) as root:
        urls = [root + "/img/part-00000"]
        if option == "store":
            pipe = ImagePipeline(files, parse, store=LocalStore(), **common)
        elif option == "prefetch":
            pipe = ImagePipeline(urls, parse, store=HTTPStore(), prefetch="2", **common)
        else:
            pipe = ImagePipeline(urls, parse, **common)
            assert isinstance(pipe.store, HTTPStore)
        assert _image_stream(pipe) == want
