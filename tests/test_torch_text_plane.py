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
    assert framing.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    got = transformer_spark.make_text_corpus(str(tmp_path / "py"), num_shards=1, records_per_shard=30)
    with open(got[0], "rb") as fg, open(want[0], "rb") as fw:
        assert fg.read() == fw.read()


@pytest.mark.parametrize("make", [
    lambda f: TextPipeline(f, Tokenizer(kind="byte"), 65, 2, pack_workers=2),
    lambda f: TextPipeline(f, Tokenizer(kind="byte"), 65, 2, slab_cache_dir="c"),
    lambda f: ImagePipeline(f, None, 2, decode_workers=2),
    lambda f: ImagePipeline(f, None, 2, store=object()),
    lambda f: ImagePipeline(f, None, 2, prefetch="2"),
    lambda f: ImagePipeline(f, None, 2, readahead="auto"),
    lambda f: ImagePipeline(["http://host/part-00000"], None, 2),
], ids=["pack_workers", "slab_cache", "decode_workers", "store", "prefetch", "readahead_auto",
        "http_shards"])
def test_unported_pipeline_options_are_refused(tmp_path, make):
    """The forked pack/decode plane, the slab cache, remote stores, staging
    and the read-ahead autotuner are not in the port yet: asking for them
    raises instead of running something else."""
    with pytest.raises(NotImplementedError, match="not yet ported"):
        make(_corpus(tmp_path, n=6, shards=1))
