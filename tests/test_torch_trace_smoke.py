"""End-to-end tracing-plane smoke: one small train on the local backend must
leave flight shards from every process tier (driver, Spark executor, jax
child) that merge into a schema-valid, single-trace Chrome timeline.

Driven by ``./run_tests.sh --trace-smoke``, which exports ``TOS_TRACE_DIR``
(so the shards survive for the CLI-side ``tracemerge --check`` assertions)
and a benign one-shot chaos plan (so the automatic ring dump on fault
injection is exercised too).  Standalone runs record into a tmp dir.
"""

import os

import pytest

from tensorflowonspark_tpu_torch import TFCluster
from tensorflowonspark_tpu_torch.TFCluster import InputMode
from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
from tensorflowonspark_tpu_torch.obs import flight, tracemerge, tracing

pytestmark = pytest.mark.slow


def fn_consume_all(args, ctx):
    feed = ctx.get_data_feed()
    while not feed.should_stop():
        feed.next_batch(16)


class TestTraceSmoke:
    def test_train_leaves_mergeable_flight_recording(self, tmp_path, monkeypatch):
        root = os.environ.get(flight.TRACE_DIR_ENV) or str(tmp_path / "traces")
        tracing.reset()
        monkeypatch.setenv(flight.TRACE_DIR_ENV, root)
        sc = LocalSparkContext(num_executors=1, task_timeout=120)
        try:
            cluster = TFCluster.run(
                sc, fn_consume_all, {}, num_executors=1,
                input_mode=InputMode.SPARK, master_node=None,
                env={"TOS_PLATFORM": "cpu"}, jax_distributed=False,
                reservation_timeout=180,
            )
            cluster.train(sc.parallelize(range(200), 2), feed_timeout=60)
            cluster.shutdown(timeout=120)
        finally:
            sc.stop()

        # every tier recorded its own shard
        procs = set()
        for shard in flight.list_shards(root):
            records, _ = flight.read_shard(shard)
            meta = next((r for r in records if r.get("kind") == "meta"), {})
            procs.add(meta.get("proc", "?"))
        assert "driver" in procs
        assert any(p.startswith("executor") for p in procs)
        assert any(p.startswith("trainer-") for p in procs)

        trace, summary = tracemerge.merge_directory(root)
        assert tracemerge.validate_chrome_trace(trace) == []
        assert len(summary["trace_ids"]) == 1
        span_names = {
            e["name"] for e in trace["traceEvents"] if e.get("ph") in ("B", "X")
        }
        assert {"reservation_roundtrip", "node_launch", "node_main",
                "feed_wave"} <= span_names
        if os.environ.get("TOS_CHAOS_PLAN"):
            # the benign fault must have force-dumped someone's ring
            assert any(
                e.get("ph") == "i" and e.get("name") == "flight_dump"
                for e in trace["traceEvents"]
            )
