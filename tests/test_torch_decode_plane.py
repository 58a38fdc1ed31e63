"""The port's forked decode plane: a ``data.decode_kill`` chaos run loses
and duplicates no row (the stream stays the JAX package's), a corrupt
record is charged against ``max_bad_records`` across the process boundary
as the JAX package charges it, the plane's teardown lets its workers exit
by themselves, and the text plane's ``TextPipeline(pack_workers=2)`` and
packed-slab cache deliver the JAX package's rows byte for byte. Every
wait on a worker process is bounded (``close``'s deadline, the producer's
join)."""

import os

import numpy as np
import pytest
from torch_plane_util import stream, write_imagenet_shards

from tensorflowonspark_tpu import tfrecord as jax_tfrecord
from tensorflowonspark_tpu.data import ImagePipeline as JImagePipeline
from tensorflowonspark_tpu.data import TextPipeline as JTextPipeline
from tensorflowonspark_tpu.data import Tokenizer as JTokenizer
from tensorflowonspark_tpu.data import imagenet as jax_imagenet
from tensorflowonspark_tpu_torch import chaos, obs
from tensorflowonspark_tpu_torch.data import ImagePipeline, TextPipeline, Tokenizer, decode_plane, imagenet

KEYS = ("tokens", "segment_ids", "positions")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("TOS_DECODE_WORKERS", "TOS_SLAB_CACHE_DIR", "TOS_NATIVE_DECODE"):
        monkeypatch.delenv(var, raising=False)
    chaos.uninstall()
    yield
    chaos.uninstall()


def _counter(name):
    return obs.snapshot()["counters"].get(name, {}).get("value", 0)


def _parses(training=True):
    kw = dict(image_size=20, seed=4, raw_uint8=True)
    return imagenet.make_parse_fn(training, **kw), jax_imagenet.make_parse_fn(training, **kw)


@pytest.mark.chaos
def test_decode_kill_loses_and_duplicates_no_row(tmp_path):
    """A worker SIGKILLed mid-round in the first of twelve rounds: its slots
    are re-leased to the respawned worker (the death is seen at the latest
    when the next round leases to the dead pipe), every label comes out
    exactly once, and the batches are the JAX package's thread-pool
    batches. One kill: a second one may land on the first victim before it
    is reaped, so only the first is sure to be a death of its own."""
    files = write_imagenet_shards(tmp_path, n=48, shards=3)
    parse, jparse = _parses()
    kw = dict(batch_size=4, seed=2, epochs=1)
    want = stream(JImagePipeline(files, jparse, decode_workers=0, **kw))
    plan = chaos.ChaosPlan(seed=1).site("data.decode_kill", probability=1.0, max_count=1)
    chaos.install(plan, propagate=False)
    restarts = _counter("decode_worker_restarts_total")
    got = stream(ImagePipeline(files, parse, decode_workers=2, **kw))
    assert plan.fired("data.decode_kill") == 1
    assert _counter("decode_worker_restarts_total") - restarts == 1
    assert got == want
    labels = np.concatenate([np.frombuffer(b[3], np.int32) for b in got])
    assert sorted(labels.tolist()) == list(range(48))


def test_corrupt_record_is_charged_across_the_process_boundary(tmp_path):
    """One undecodable JPEG within a ``max_bad_records=1`` budget: skipped
    in the workers as in the JAX package's thread pool, the same batches;
    with no budget the pipeline raises."""
    files = write_imagenet_shards(tmp_path, n=12, shards=1)
    recs = list(jax_tfrecord.read_records(files[0]))
    recs[5] = jax_tfrecord.encode_example({"image/encoded": [b"\xff\xd8 not a jpeg"],
                                           "image/class/label": [5]})
    bad = str(tmp_path / "bad" / "part-00000")
    os.makedirs(os.path.dirname(bad))
    with jax_tfrecord.TFRecordWriter(bad) as w:
        for r in recs:
            w.write(r)
    parse, jparse = _parses()
    kw = dict(batch_size=4, seed=0, epochs=1, max_bad_records=1)
    want = stream(JImagePipeline([bad], jparse, decode_workers=0, **kw))
    skipped = _counter("data_records_skipped_total")
    assert stream(ImagePipeline([bad], parse, decode_workers=2, **kw)) == want
    assert _counter("data_records_skipped_total") - skipped == 1
    with pytest.raises(Exception):
        stream(ImagePipeline([bad], parse, 4, seed=0, epochs=1, decode_workers=2))


def test_teardown_lets_the_workers_exit_by_themselves(tmp_path):
    """Closing the plane closes each lease pipe and every worker sees EOF
    (each child closed the parent's ends the fork copied), so none is
    killed at the deadline: exit code 0, not -SIGKILL."""
    parse, _ = _parses()
    plane = decode_plane.DecodePlane(parse, 3)
    procs = [w.proc for w in plane._workers]
    plane.resize(2)  # a retired worker exits at EOF too
    plane.close(timeout=30.0)
    assert [p.exitcode for p in procs] == [0, 0, 0]


def _text_corpus(tmp_path, n=120, shards=3, seed=0):
    rng = np.random.default_rng(seed)
    words = "spark text plane packs variable length sequences tightly".split()
    per = -(-n // shards)
    paths = []
    for s in range(shards):
        path = str(tmp_path / "part-{:05d}".format(s))
        with jax_tfrecord.TFRecordWriter(path) as w:
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


def _same(got, want):
    return len(got) == len(want) > 0 and all(
        g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]) for g, w in zip(got, want) for k in KEYS)


@pytest.mark.parametrize("kind, seq_len", [("byte", 65), ("word", 33)])
def test_text_pack_workers_rows_are_byte_identical(tmp_path, kind, seq_len):
    """``TextPipeline(pack_workers=2)`` and the packed-slab cache (cold,
    then warm) against the JAX package's stream on the same corpus and
    seed (the JAX package's is the same in every pack mode)."""
    files = _text_corpus(tmp_path)
    vocab = 512 if kind == "word" else None
    common = dict(seq_len=seq_len, batch_size=3, seed=3, epochs=1)
    want = _rows(JTextPipeline(files, JTokenizer(kind=kind, vocab_size=vocab), pack_workers=0, **common))
    assert _same(_rows(TextPipeline(files, Tokenizer(kind=kind, vocab_size=vocab), pack_workers=2, **common)), want)
    cache = str(tmp_path / "packed-cache")
    hits = _counter("decode_cache_hits_total")
    for _ in ("cold", "warm"):
        assert _same(_rows(TextPipeline(files, Tokenizer(kind=kind, vocab_size=vocab), slab_cache_dir=cache,
                                        **common)), want)
    assert _counter("decode_cache_hits_total") > hits  # the warm pass read the cache
