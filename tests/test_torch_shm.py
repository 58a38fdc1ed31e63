"""Shared-memory feed-chunk tests: columnar layout, fallback rules, segment
lifecycle, and the DataFeed integration."""

import os

import numpy as np
import pytest

from tensorflowonspark_tpu_torch.shm import NAME_PREFIX, ShmChunk, unlink_leaked


def _segments():
    shm_dir = "/dev/shm"
    if not os.path.isdir(shm_dir):
        return set()
    return {f for f in os.listdir(shm_dir) if f.startswith(NAME_PREFIX)}


def test_tuple_rows_roundtrip_and_unlink():
    rows = [([float(i)] * 8, i % 3) for i in range(50)]
    before = _segments()
    chunk = ShmChunk.from_rows(rows)
    assert chunk is not None
    assert len(chunk) == 50
    assert _segments() - before, "segment should exist before materialize"
    out = chunk.rows()
    assert _segments() == before, "segment should be unlinked after materialize"
    assert len(out) == 50
    np.testing.assert_allclose(np.asarray(out[7][0]), [7.0] * 8)
    assert int(out[7][1]) == 1


def test_single_column_vector_rows():
    """784-float rows are ONE logical field, not 784 columns."""
    rows = [[float(i)] * 784 for i in range(20)]
    chunk = ShmChunk.from_rows(rows)
    assert chunk is not None
    assert chunk.single
    assert len(chunk.columns) == 1
    dtype, shape, _off = chunk.columns[0]
    assert shape == (20, 784)
    out = chunk.rows()
    np.testing.assert_allclose(np.asarray(out[3]), [3.0] * 784)


def test_wide_scalar_rows_with_mixed_kinds_stay_multi():
    """A 20-field row of 19 floats + 1 int label must NOT collapse into one
    float64 column (the label dtype must survive the lane)."""
    rows = [tuple([float(i)] * 19 + [i]) for i in range(8)]
    chunk = ShmChunk.from_rows(rows)
    assert chunk is not None
    assert not chunk.single
    assert len(chunk.columns) == 20
    out = chunk.rows()
    assert np.asarray(out[3][19]).dtype.kind == "i"


def test_wide_uniform_scalar_rows_are_single_column():
    rows = [[float(i)] * 784 for i in range(4)]
    chunk = ShmChunk.from_rows(rows)
    assert chunk is not None and chunk.single


def test_scalar_rows():
    chunk = ShmChunk.from_rows(list(range(10)))
    assert chunk is not None and chunk.single
    assert [int(v) for v in chunk.rows()] == list(range(10))


def test_non_numeric_rows_fall_back():
    assert ShmChunk.from_rows(["a", "b"]) is None
    assert ShmChunk.from_rows([("x", 1), ("y", 2)]) is None
    assert ShmChunk.from_rows([(b"raw", 1)]) is None
    # ragged rows
    assert ShmChunk.from_rows([([1, 2], 0), ([1, 2, 3], 1)]) is None
    assert ShmChunk.from_rows([]) is None


def test_discard_unlinks_without_reading():
    chunk = ShmChunk.from_rows([(1.0, 2.0)])
    before = _segments()
    assert any(chunk.name in s for s in before)
    chunk.discard()
    assert chunk.name not in _segments()
    chunk.discard()  # idempotent


def test_unlink_leaked_age_gate(tmp_path, monkeypatch):
    # isolate the janitor's namespace: /dev/shm is shared with concurrent
    # xdist workers' live feed segments and with stale leaks from other
    # (killed) runs — scan/reap only this test's own prefix
    import os

    import tensorflowonspark_tpu_torch.shm as shm_mod

    monkeypatch.setattr(shm_mod, "NAME_PREFIX", "tosfeedtest{}_".format(os.getpid()))
    chunk = ShmChunk.from_rows([(1.0, 2.0)])
    try:
        # too young: janitor must not touch it (membership checked against
        # the raw dir: _segments() filters by the UNPATCHED prefix)
        assert unlink_leaked(max_age_secs=3600) == 0
        assert chunk.name in os.listdir("/dev/shm")
        # old enough: reaped
        assert unlink_leaked(max_age_secs=0) >= 1
        assert chunk.name not in os.listdir("/dev/shm")
    finally:
        chunk.discard()


def test_datafeed_consumes_shm_chunks():
    """DataFeed serves ShmChunk rows with deferred task_done, same as a
    pickled Chunk; as_numpy gives device-put-ready columns."""
    from tensorflowonspark_tpu_torch import TFManager
    from tensorflowonspark_tpu_torch.TFNode import DataFeed

    mgr = TFManager.start(b"shm-test", ["input", "output"], mode="local")
    try:
        q = mgr.get_queue("input")
        rows = [([float(i)] * 4, i) for i in range(6)]
        q.put(ShmChunk.from_rows(rows[:4]))
        q.put(ShmChunk.from_rows(rows[4:]))
        q.put(None)

        feed = DataFeed(mgr, train_mode=False, input_mapping={"a": "x", "b": "y"})
        batch = feed.next_batch(5, as_numpy=True)
        assert set(batch) == {"x", "y"}
        assert batch["x"].shape == (5, 4)
        np.testing.assert_allclose(batch["x"][2], [2.0] * 4)
        rest = feed.next_batch(5, as_numpy=True)  # 1 pending row + end-of-feed
        assert rest["x"].shape == (1, 4)
        assert feed.should_stop()
        assert q.unfinished() == 0, "deferred task_done must fully drain"
    finally:
        mgr.shutdown()


def test_datafeed_columnar_fast_lane_slices_across_boundaries():
    """as_numpy+mapping consumers get column SLICES (no row objects) even
    when batch boundaries cut through shm chunks, with correct ordering and
    values across chunk joins; a pickled Chunk interleaved mid-stream merges
    into the same output columns."""
    from tensorflowonspark_tpu_torch import TFManager
    from tensorflowonspark_tpu_torch.TFNode import DataFeed
    from tensorflowonspark_tpu_torch.marker import Chunk

    mgr = TFManager.start(b"shm-colfast", ["input", "output"], mode="local")
    try:
        q = mgr.get_queue("input")
        rows = [([float(i)] * 3, i) for i in range(10)]
        q.put(ShmChunk.from_rows(rows[:6]))
        q.put(Chunk(rows[6:8]))  # pickled rows interleave
        q.put(ShmChunk.from_rows(rows[8:]))
        q.put(None)
        feed = DataFeed(mgr, train_mode=False, input_mapping={"a": "x", "b": "y"})
        b1 = feed.next_batch(4, as_numpy=True)   # slice of chunk 1
        b2 = feed.next_batch(5, as_numpy=True)   # chunk1 tail + pickled + chunk2 head
        b3 = feed.next_batch(4, as_numpy=True)   # chunk2 tail + end-of-feed
        assert b1["x"].shape == (4, 3) and b2["x"].shape == (5, 3) and b3["x"].shape == (1, 3)
        got = np.concatenate([b["y"] for b in (b1, b2, b3)])
        np.testing.assert_array_equal(got, np.arange(10))
        np.testing.assert_allclose(b2["x"][0], [4.0] * 3)
        assert feed.should_stop()
        assert q.unfinished() == 0
    finally:
        mgr.shutdown()


def test_datafeed_plain_consumer_gets_python_types():
    """Without as_numpy, the shm lane delivers the exact Python types the
    feeder saw — no silent list→ndarray / int→np.int64 changes inside user
    main_fun code."""
    from tensorflowonspark_tpu_torch import TFManager
    from tensorflowonspark_tpu_torch.TFNode import DataFeed

    mgr = TFManager.start(b"shm-test-py", ["input", "output"], mode="local")
    try:
        q = mgr.get_queue("input")
        rows = [([1.0, 2.0, 3.0], 7), ([4.0, 5.0, 6.0], 8)]
        q.put(ShmChunk.from_rows(rows))
        q.put(None)
        feed = DataFeed(mgr, train_mode=False)
        batch = feed.next_batch(4)
        assert len(batch) == 2
        assert isinstance(batch[0][0], list) and batch[0][0] == [1.0, 2.0, 3.0]
        assert type(batch[0][1]) is int and batch[0][1] == 7
        import json as _json

        _json.dumps(batch)  # fully JSON-serializable, as pickled rows were
    finally:
        mgr.shutdown()


def test_datafeed_terminate_discards_unread_segments():
    from tensorflowonspark_tpu_torch import TFManager
    from tensorflowonspark_tpu_torch.TFNode import DataFeed

    mgr = TFManager.start(b"shm-test2", ["input", "output"], mode="local")
    try:
        q = mgr.get_queue("input")
        chunk = ShmChunk.from_rows([(1.0, 2)] * 10)
        q.put(chunk)
        feed = DataFeed(mgr, train_mode=False)
        feed.terminate()
        assert chunk.name not in _segments()
    finally:
        mgr.shutdown()


def test_feeder_tasks_use_shm_lane():
    """_put_rows ships numeric rows via shared memory and falls back for
    non-numeric; the message on the queue proves which lane was taken."""
    from tensorflowonspark_tpu_torch import TFManager, TFSparkNode
    from tensorflowonspark_tpu_torch.marker import Chunk

    mgr = TFManager.start(b"shm-test3", ["input"], mode="local")
    try:
        q = mgr.get_queue("input")
        TFSparkNode._put_rows(q, [(1.0, 2), (3.0, 4)])
        item = q.get()
        q.task_done()
        assert isinstance(item, ShmChunk)
        item.discard()
        TFSparkNode._put_rows(q, [("s", 1)])
        item = q.get()
        q.task_done()
        assert isinstance(item, Chunk)
    finally:
        mgr.shutdown()


def test_no_resource_tracker_keyerror_spam():
    """materialize()/discard() must not double-unregister: CPython registers
    a segment with the resource_tracker on ATTACH too, and ``unlink()``
    already unregisters it — an extra manual unregister after unlink made
    the tracker's ``cache.remove()`` raise KeyError tracebacks into every
    consumer process's stderr."""
    import subprocess
    import sys

    script = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
from tensorflowonspark_tpu_torch.shm import ShmChunk

for i in range(5):
    chunk = ShmChunk.from_rows(
        [(np.arange(4, dtype=np.float32) + j, j % 3) for j in range(32)]
    )
    assert chunk is not None
    assert len(chunk.rows()) == 32
chunk = ShmChunk.from_rows([(1.0, 2)] * 8)
chunk.discard()
chunk.discard()  # double-discard: second attach fails cleanly
print("SHM_TRACKER_OK")
""".format(repo=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    # the tracker process inherits stderr, so run() only returns once the
    # tracker has drained and closed it — any KeyError spam is captured
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "SHM_TRACKER_OK" in proc.stdout
    assert "KeyError" not in proc.stderr, proc.stderr[-2000:]
    assert "resource_tracker" not in proc.stderr, proc.stderr[-2000:]
