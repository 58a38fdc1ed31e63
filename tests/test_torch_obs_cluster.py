"""Integration: a 2-node cluster's metrics flow — child registries published
over the TFManager channel, feed tasks accumulated on the feeder lane, all
merged by ``TFCluster.metrics()`` into one cluster snapshot."""

import time

import pytest

from tensorflowonspark_tpu_torch import TFCluster, util
from tensorflowonspark_tpu_torch.TFCluster import InputMode
from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext

CPU_ENV = {util.ENV_PLATFORM: "cpu"}


@pytest.fixture
def sc():
    ctx = LocalSparkContext(num_executors=2, task_timeout=120)
    yield ctx
    ctx.stop()


def fn_square_feed_with_metric(args, ctx):
    # the jax child's process-global registry: published periodically by the
    # SnapshotPublisher the node runtime starts
    from tensorflowonspark_tpu_torch import obs
    from tensorflowonspark_tpu_torch.data import FeedAutotuner

    obs.counter("child_marks_total", help="one per node main_fun entry").inc()
    # the feed autotuner publishes its link estimate and window choice into
    # the same registry (pure controller API: no device traffic needed)
    tuner = FeedAutotuner()
    tuner.note_fixed_probe(0.25)
    tuner.note_transfer(1 << 20, 0.25 + 0.05)
    tuner.decide(1 << 20)
    feed = ctx.get_data_feed(train_mode=False)
    while not feed.should_stop():
        batch = feed.next_batch(16)
        if batch:
            feed.batch_results([x * x for x in batch])


class TestClusterMetrics:
    def test_metrics_returns_merged_cluster_snapshot(self, sc):
        cluster = TFCluster.run(
            sc, fn_square_feed_with_metric, {}, num_executors=2,
            input_mode=InputMode.SPARK, master_node=None,
            env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
        )
        try:
            results = cluster.inference(sc.parallelize(range(100), 4)).collect()
            assert sorted(results) == sorted(x * x for x in range(100))

            # the feeder lane is accumulated synchronously at task end, but the
            # child lane is published on an interval — poll until both nodes'
            # child registries have landed
            deadline = time.monotonic() + 60
            while True:
                snap = cluster.metrics()
                marks = snap["counters"].get("child_marks_total", {}).get("value", 0)
                if marks >= 2 or time.monotonic() > deadline:
                    break
                time.sleep(0.5)

            # cluster-level sums: one mark per node, every row fed + returned
            assert snap["counters"]["child_marks_total"]["value"] == 2
            assert snap["counters"]["feed_rows_total"]["value"] == 100
            assert snap["counters"]["inference_results_total"]["value"] == 100
            # driver registry rides along: the reservation server counted both
            # node registrations (process-global, so >= in case other tests ran)
            assert snap["counters"]["reservation_registrations_total"]["value"] >= 2
            # per-node detail survives the merge
            assert set(snap["nodes"]) == {"worker:0", "worker:1"}
            for node_snap in snap["nodes"].values():
                assert node_snap["counters"]["child_marks_total"]["value"] == 1
            # the adaptive feed's five metrics cross the channel: gauges and
            # counters published by the node-side FeedAutotuner land in the
            # cluster view
            for name in (
                "feed_link_bytes_per_sec",
                "feed_transfer_fixed_cost_seconds",
                "feed_window_size",
                "feed_recompiles_total",
                "feed_transfer_seconds_total",
            ):
                assert (
                    name in snap["gauges"] or name in snap["counters"]
                ), name
            # cross-node gauge semantic is SUM: two nodes x 0.25s fixed cost.
            # Exact sums are asserted on a driver-free snapshot — the driver
            # registry is process-global, and a tuner created by an earlier
            # test in this process would otherwise ride into the sum.
            nodrv = cluster.metrics(include_driver=False)
            assert nodrv["gauges"]["feed_transfer_fixed_cost_seconds"]["value"] == pytest.approx(0.5)
            assert nodrv["counters"]["feed_transfer_seconds_total"]["value"] == pytest.approx(0.6)
            for node_snap in snap["nodes"].values():
                assert node_snap["gauges"]["feed_transfer_fixed_cost_seconds"]["value"] == pytest.approx(0.25)
            # lifecycle spans crossed the channel as events
            assert any(e.get("span") == "inference_wave" for e in snap["events"])
            # snapshot is JSON-able end to end (the exporter contract)
            import json

            json.dumps(snap)
        finally:
            cluster.shutdown(timeout=120)

    def test_metrics_without_driver_registry(self, sc):
        cluster = TFCluster.run(
            sc, fn_square_feed_with_metric, {}, num_executors=2,
            input_mode=InputMode.SPARK, master_node=None,
            env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
        )
        try:
            cluster.inference(sc.parallelize(range(20), 2)).collect()
            snap = cluster.metrics(include_driver=False)
            # node-side feed counters present; driver-only counters absent
            assert snap["counters"]["feed_rows_total"]["value"] == 20
            assert "reservation_registrations_total" not in snap["counters"]
        finally:
            cluster.shutdown(timeout=120)
