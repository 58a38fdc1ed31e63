"""Unit tests for the obs registry, trace spans, and snapshot merging."""

import json
import sys
import threading

import pytest

from tensorflowonspark_tpu_torch.obs import aggregate, registry, trace
from tensorflowonspark_tpu_torch.obs.registry import Registry


def test_counter_gauge_histogram_basics():
    reg = Registry()
    c = reg.counter("rows_total", help="rows")
    c.inc()
    c.inc(4)
    assert c.value == 5
    g = reg.gauge("depth")
    g.set(3)
    g.inc()
    g.dec(2)
    assert g.value == 2
    h = reg.histogram("lat_seconds", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)  # above the last bound: count/sum only
    assert h.count == 3
    assert h.sum == pytest.approx(5.55)
    snap = h._snapshot()
    assert snap["buckets"] == [[0.1, 1], [1.0, 1]]


def test_get_or_create_returns_same_instrument_and_rejects_kind_clash():
    reg = Registry()
    assert reg.counter("x") is reg.counter("x")
    with pytest.raises(ValueError):
        reg.gauge("x")


def test_snapshot_is_json_able_and_round_trips():
    reg = Registry()
    reg.counter("a").inc()
    reg.gauge("b").set(2.5)
    reg.histogram("c").observe(0.01)
    reg.add_event({"span": "s", "ts": 1.0, "dur_s": 0.1, "ok": True})
    snap = json.loads(json.dumps(reg.snapshot()))
    assert snap["counters"]["a"]["value"] == 1
    assert snap["gauges"]["b"]["value"] == 2.5
    assert snap["histograms"]["c"]["count"] == 1
    assert snap["events"][0]["span"] == "s"


def test_disabled_registry_records_nothing():
    reg = Registry(enabled=False)
    c = reg.counter("n")
    c.inc()
    reg.gauge("g").set(9)
    reg.histogram("h").observe(1)
    reg.add_event({"e": 1})
    snap = reg.snapshot()
    assert snap["counters"]["n"]["value"] == 0
    assert snap["gauges"]["g"]["value"] == 0
    assert snap["histograms"]["h"]["count"] == 0
    assert snap["events"] == []


def test_disabled_inc_allocates_nothing_per_step():
    """The off-the-hot-path guarantee: with the registry disabled, per-step
    instrument calls allocate no objects at all."""
    reg = Registry(enabled=False)
    c = reg.counter("steps_total")
    h = reg.histogram("step_seconds")
    span = trace.span("step", registry=reg)  # shared _NULL singleton
    # warm up any lazy attribute caches before measuring
    for _ in range(10):
        c.inc()
        h.observe(0.1)
        with span:
            pass
    before = sys.getallocatedblocks()
    for _ in range(1000):
        c.inc()
        h.observe(0.1)
        with trace.span("step", registry=reg):
            pass
    grown = sys.getallocatedblocks() - before
    # zero in practice; tolerate interpreter-internal noise, but 1000
    # iterations of real allocation would show thousands of blocks
    assert grown < 50, "disabled instruments allocated {} blocks".format(grown)


def test_span_records_event_and_histogram():
    reg = Registry()
    with trace.span("launch", registry=reg, node=3) as sp:
        sp.set(extra="yes")
    events = reg.events()
    assert len(events) == 1
    ev = events[0]
    assert ev["span"] == "launch" and ev["ok"] and ev["node"] == 3 and ev["extra"] == "yes"
    assert ev["dur_s"] >= 0
    assert reg.histogram("launch_seconds").count == 1


def test_span_marks_failure_and_propagates():
    reg = Registry()
    with pytest.raises(RuntimeError):
        with trace.span("boom", registry=reg):
            raise RuntimeError("x")
    assert reg.events()[0]["ok"] is False


def test_event_buffer_is_bounded():
    reg = Registry()
    for i in range(registry.MAX_EVENTS + 10):
        reg.add_event({"i": i})
    events = reg.events()
    assert len(events) == registry.MAX_EVENTS
    assert events[-1]["i"] == registry.MAX_EVENTS + 9


def test_thread_safety_of_counters():
    reg = Registry()
    c = reg.counter("n")

    def work():
        for _ in range(10000):
            c.inc()

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == 40000


def test_merge_snapshots_sums_counters_and_buckets():
    a, b = Registry(), Registry()
    a.counter("n").inc(2)
    b.counter("n").inc(3)
    a.gauge("depth").set(4)
    b.gauge("depth").set(6)
    a.histogram("lat", buckets=(1.0, 2.0)).observe(0.5)
    b.histogram("lat", buckets=(1.0, 2.0)).observe(1.5)
    merged = aggregate.merge_snapshots([a.snapshot(), b.snapshot()])
    assert merged["counters"]["n"]["value"] == 5
    assert merged["gauges"]["depth"]["value"] == 10  # cross-node: summed
    assert merged["histograms"]["lat"]["count"] == 2
    assert merged["histograms"]["lat"]["buckets"] == [[1.0, 1], [2.0, 1]]


def test_merge_snapshots_gauges_last_for_time_accumulation():
    older, newer = Registry(), Registry()
    older.gauge("depth").set(10)
    newer.gauge("depth").set(2)
    merged = aggregate.merge_snapshots([older.snapshot(), newer.snapshot()], gauges="last")
    assert merged["gauges"]["depth"]["value"] == 2


def test_merge_snapshots_orders_and_bounds_events():
    a, b = Registry(), Registry()
    a.add_event({"span": "x", "ts": 2.0})
    b.add_event({"span": "y", "ts": 1.0})
    merged = aggregate.merge_snapshots([a.snapshot(), b.snapshot()])
    assert [e["span"] for e in merged["events"]] == ["y", "x"]


class _FakeMgr:
    """Duck-typed TFManager k/v surface for channel publication tests."""

    def __init__(self):
        self.kv = {}

    def set(self, key, value):
        self.kv[key] = value

    def get(self, key):
        return self.kv.get(key)


def test_publish_and_read_channel_round_trip():
    mgr = _FakeMgr()
    reg = Registry()
    reg.counter("n").inc(7)
    aggregate.publish_to_channel(mgr, reg)
    snaps = aggregate.read_channel_snapshots(mgr)
    assert len(snaps) == 1
    assert snaps[0]["counters"]["n"]["value"] == 7


def test_accumulate_to_channel_merges_successive_tasks():
    mgr = _FakeMgr()
    for rows in (5, 7):
        task_reg = Registry()  # private per-task registry, as the feed tasks use
        task_reg.counter("feed_rows_total").inc(rows)
        task_reg.gauge("feed_queue_depth").set(rows)
        aggregate.accumulate_to_channel(mgr, task_reg)
    (snap,) = aggregate.read_channel_snapshots(mgr, keys=(aggregate.FEEDER_KEY,))
    assert snap["counters"]["feed_rows_total"]["value"] == 12
    # same-node over time: depth is the LAST wave's, not the sum
    assert snap["gauges"]["feed_queue_depth"]["value"] == 7


def test_snapshot_publisher_publishes_and_flushes_on_stop():
    mgr = _FakeMgr()
    reg = Registry()
    reg.counter("beats").inc()
    pub = aggregate.SnapshotPublisher(mgr, reg, interval=0.05).start()
    pub.stop()
    (snap,) = aggregate.read_channel_snapshots(mgr, keys=(aggregate.CHANNEL_KEY,))
    assert snap["counters"]["beats"]["value"] == 1


def test_snapshot_publisher_disabled_registry_spins_nothing():
    mgr = _FakeMgr()
    pub = aggregate.SnapshotPublisher(mgr, Registry(enabled=False), interval=0.01).start()
    assert pub._thread is None
    pub.stop()
    assert mgr.kv == {}
