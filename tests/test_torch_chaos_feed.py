"""Chaos: the feed layer (TFManager queues, DataFeed, data loader) under
injected stalls, truncated chunks and poisoned records. Delay faults must
only slow delivery; a poisoned record is absorbed by the loader's
``max_bad_records`` budget with full-size batches preserved, and surfaces
as the parse error once the budget is spent."""

import numpy as np
import pytest

from tensorflowonspark_tpu_torch import TFManager, TFNode, chaos, obs, tfrecord
from tensorflowonspark_tpu_torch.TFSparkNode import _chaos_trim
from tensorflowonspark_tpu_torch.data import ImagePipeline

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.uninstall()
    yield
    chaos.uninstall()


@pytest.fixture
def ipc():
    mgr = TFManager.start(authkey=b"chaos-key", queues=("input", "output", "error"))
    yield mgr
    mgr.shutdown()


def _counter(name):
    return obs.snapshot()["counters"].get(name, {}).get("value", 0)


class TestFeedStalls:
    def test_stalled_puts_and_slow_consumer_still_deliver(self, ipc):
        plan = (
            chaos.ChaosPlan(seed=0)
            .site("feed.stall", probability=1.0, max_count=3, delay_s=0.01)
            .site("feed.slow_consumer", probability=1.0, max_count=2, delay_s=0.01)
        )
        chaos.install(plan, propagate=False)
        q = ipc.get_queue("input")
        for i in range(6):
            q.put(i)
        q.put(None)  # end-of-feed
        feed = TFNode.DataFeed(ipc)
        assert feed.next_batch(4) == [0, 1, 2, 3]
        assert feed.next_batch(100) == [4, 5]
        assert feed.should_stop()
        assert plan.fired("feed.stall") == 3
        assert plan.fired("feed.slow_consumer") == 2


class TestTruncatedChunk:
    def test_chaos_trim_halves_a_train_chunk(self):
        chaos.install(
            chaos.ChaosPlan(seed=0).site("feed.truncate_chunk", probability=1.0,
                                         max_count=1),
            propagate=False,
        )
        buf = list(range(10))
        assert _chaos_trim(buf) == [0, 1, 2, 3, 4]  # tail dropped
        assert _chaos_trim(buf) == buf  # budget spent: pass-through
        assert _counter("chaos_fault_feed_truncate_chunk_total") >= 1

    def test_chaos_trim_never_empties_the_chunk(self):
        chaos.install(
            chaos.ChaosPlan(seed=0).site("feed.truncate_chunk", probability=1.0),
            propagate=False,
        )
        assert _chaos_trim([7]) == [7]  # at least one row always survives


def _int_shard(tmp_path, values):
    shard = str(tmp_path / "part-00000")
    with tfrecord.TFRecordWriter(shard) as w:
        for v in values:
            w.write(str(v).encode("ascii"))
    return shard


def _int_parse(rec):
    v = int(rec)  # raises ValueError on a poisoned record
    return np.full((2, 2, 1), v, np.float32), v


class TestPoisonedRecords:
    def test_budget_absorbs_poison_with_full_batches(self, tmp_path):
        plan = chaos.ChaosPlan(seed=0).site("data.poison", probability=1.0, max_count=2)
        chaos.install(plan, propagate=False)
        skipped_before = _counter("data_records_skipped_total")
        pipe = ImagePipeline(
            [_int_shard(tmp_path, range(8))], _int_parse,
            batch_size=2, shuffle=False, epochs=1, num_threads=2,
            max_bad_records=2,
        )
        batches = list(pipe)
        # 2 of 8 records poisoned -> 6 good ones -> 3 FULL batches (good
        # records backfill across chunk boundaries)
        assert len(batches) == 3
        assert all(b["image"].shape == (2, 2, 2, 1) for b in batches)
        assert [v for b in batches for v in b["label"].tolist()] == [2, 3, 4, 5, 6, 7]
        assert plan.fired("data.poison") == 2
        assert _counter("data_records_skipped_total") - skipped_before == 2

    def test_exhausted_budget_surfaces_the_parse_error(self, tmp_path):
        chaos.install(
            chaos.ChaosPlan(seed=0).site("data.poison", probability=1.0, max_count=2),
            propagate=False,
        )
        pipe = ImagePipeline(
            [_int_shard(tmp_path, range(8))], _int_parse,
            batch_size=2, shuffle=False, epochs=1, num_threads=2,
            max_bad_records=1,
        )
        with pytest.raises(ValueError):
            list(pipe)

    def test_default_budget_is_strict_fail_fast(self, tmp_path):
        chaos.install(
            chaos.ChaosPlan(seed=0).site("data.poison", probability=1.0, max_count=1),
            propagate=False,
        )
        pipe = ImagePipeline(
            [_int_shard(tmp_path, range(4))], _int_parse,
            batch_size=2, shuffle=False, epochs=1, num_threads=2,
        )
        with pytest.raises(ValueError):
            list(pipe)


class TestProducerDelay:
    def test_delay_only_slows_the_pipeline(self, tmp_path):
        plan = chaos.ChaosPlan(seed=0).site(
            "data.producer_delay", probability=1.0, max_count=2, delay_s=0.01
        )
        chaos.install(plan, propagate=False)
        pipe = ImagePipeline(
            [_int_shard(tmp_path, range(8))], _int_parse,
            batch_size=2, shuffle=False, epochs=1, num_threads=2,
        )
        batches = list(pipe)
        assert len(batches) == 4
        assert [v for b in batches for v in b["label"].tolist()] == list(range(8))
        assert plan.fired("data.producer_delay") == 2
