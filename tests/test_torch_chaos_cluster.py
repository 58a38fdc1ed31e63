"""Integration: a seeded chaos plan exercised through a live 2-node cluster.

The acceptance bar for the chaos subsystem: faults injected in every
process — the driver's reservation server and the spawned jax children —
are absorbed by the recovery machinery (the cluster assembles, inference
returns correct results) and each one is visible as a counter in the merged
``TFCluster.metrics()`` snapshot."""

import time

import pytest

from tensorflowonspark_tpu_torch import TFCluster, chaos, util
from tensorflowonspark_tpu_torch.TFCluster import InputMode
from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext

pytestmark = pytest.mark.chaos

CPU_ENV = {util.ENV_PLATFORM: "cpu"}


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.uninstall()
    yield
    chaos.uninstall()


@pytest.fixture
def sc():
    ctx = LocalSparkContext(num_executors=2, task_timeout=120)
    yield ctx
    ctx.stop()


def fn_square_feed_under_chaos(args, ctx):
    # the plan must have propagated into the spawned jax child (env lane)
    from tensorflowonspark_tpu_torch import chaos as _chaos

    assert _chaos.active, "chaos plan did not reach the jax child"
    feed = ctx.get_data_feed(train_mode=False)
    while not feed.should_stop():
        batch = feed.next_batch(16)
        if batch:
            feed.batch_results([x * x for x in batch])


def fn_pipeline_under_chaos(args, ctx):
    # the read-ahead reader must hit the data.shard_read site inside the
    # spawned child, and the fault counter must travel back through the
    # metrics merge lane
    import numpy as np

    from tensorflowonspark_tpu_torch import chaos as _chaos
    from tensorflowonspark_tpu_torch.data import ImagePipeline

    assert _chaos.active, "chaos plan did not reach the jax child"

    def parse(rec):
        v = int(rec)
        return np.full((2, 2, 1), v, np.float32), v

    pipe = ImagePipeline(
        [args["shard"]], parse, batch_size=4, shuffle=False, epochs=1,
        readahead=2, chunk_records=8,
    )
    n = sum(b["label"].shape[0] for b in pipe)
    feed = ctx.get_data_feed(train_mode=False)
    while not feed.should_stop():
        batch = feed.next_batch(16)
        if batch:
            feed.batch_results([n for _ in batch])


def _parse_2x2(rec):
    # module-level: decode-plane workers are forked, the parse fn must be
    # importable/fork-inheritable
    import numpy as np

    v = int(rec)
    return np.full((2, 2, 1), v, np.float32), v


def fn_decode_plane_under_chaos(args, ctx):
    # the decode plane runs inside the spawned jax child; the chaos kill
    # SIGKILLs one worker mid-round and the respawned pool must deliver
    # every record exactly once — the child proves the stream intact and
    # the fault/restart counters travel back through the metrics merge
    from tensorflowonspark_tpu_torch import chaos as _chaos
    from tensorflowonspark_tpu_torch.data import ImagePipeline

    assert _chaos.active, "chaos plan did not reach the jax child"

    pipe = ImagePipeline(
        [args["shard"]], _parse_2x2, batch_size=4, shuffle=False, epochs=1,
        decode_workers=2,
    )
    labels = [int(x) for b in pipe for x in b["label"]]
    ok = labels == list(range(16))
    feed = ctx.get_data_feed(train_mode=False)
    while not feed.should_stop():
        batch = feed.next_batch(16)
        if batch:
            feed.batch_results([int(ok) for _ in batch])


class TestClusterChaos:
    def test_faults_injected_and_recovered_across_the_cluster(self, sc):
        plan = (
            chaos.ChaosPlan(seed=7)
            # driver side: the reservation server drops one registration;
            # the client's shared retry policy re-registers
            .site("reservation.reg_drop", probability=1.0, max_count=1)
            # child side: the DataFeed sleeps before dequeueing
            .site("feed.slow_consumer", probability=1.0, max_count=2, delay_s=0.01)
        )
        chaos.install(plan)  # propagate=True: children inherit via env
        cluster = TFCluster.run(
            sc, fn_square_feed_under_chaos, {}, num_executors=2,
            input_mode=InputMode.SPARK, master_node=None,
            env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
        )
        try:
            # recovery completed: every row fed and answered correctly
            results = cluster.inference(sc.parallelize(range(100), 4)).collect()
            assert sorted(results) == sorted(x * x for x in range(100))

            # the driver-side fault fired in this process
            assert plan.fired("reservation.reg_drop") == 1

            # child counters arrive on the SnapshotPublisher interval — poll
            # the merged snapshot until the children's faults land
            deadline = time.monotonic() + 60
            while True:
                snap = cluster.metrics()
                child_faults = (
                    snap["counters"]
                    .get("chaos_fault_feed_slow_consumer_total", {})
                    .get("value", 0)
                )
                if child_faults >= 2 or time.monotonic() > deadline:
                    break
                time.sleep(0.5)

            counters = snap["counters"]
            # every fault class visible through cluster.metrics()
            assert counters["chaos_fault_reservation_reg_drop_total"]["value"] >= 1
            assert counters["chaos_fault_feed_slow_consumer_total"]["value"] >= 2
            assert counters["chaos_faults_injected_total"]["value"] >= 3
            # (the forced client retry is counted in the executor process's
            # registry, which has no merge lane — test_chaos_reservation
            # asserts reservation_client_retries_total in-process)
        finally:
            cluster.shutdown(timeout=120)

    def test_shard_read_faults_surface_in_cluster_metrics(self, sc, tmp_path):
        from tensorflowonspark_tpu_torch import tfrecord

        shard = str(tmp_path / "part-00000")
        with tfrecord.TFRecordWriter(shard) as w:
            for i in range(16):
                w.write(str(i).encode())

        # delay faults on every shard open: absorbed invisibly by the
        # read-ahead reader, visible only as counters
        plan = chaos.ChaosPlan(seed=3).site(
            "data.shard_read", probability=1.0, max_count=2, delay_s=0.01
        )
        chaos.install(plan)  # propagate=True: children inherit via env
        cluster = TFCluster.run(
            sc, fn_pipeline_under_chaos, {"shard": shard}, num_executors=2,
            input_mode=InputMode.SPARK, master_node=None,
            env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
        )
        try:
            # every child consumed all 16 records through the chaos-delayed
            # read-ahead path
            results = cluster.inference(sc.parallelize(range(8), 4)).collect()
            assert results == [16] * 8

            # child counters arrive on the SnapshotPublisher interval
            deadline = time.monotonic() + 60
            while True:
                snap = cluster.metrics()
                faults = (
                    snap["counters"]
                    .get("chaos_fault_data_shard_read_total", {})
                    .get("value", 0)
                )
                if faults >= 1 or time.monotonic() > deadline:
                    break
                time.sleep(0.5)
            assert faults >= 1
        finally:
            cluster.shutdown(timeout=120)

    def test_decode_kill_respawns_without_losing_rows(self, sc, tmp_path):
        import importlib.util

        if importlib.util.find_spec("multiprocessing.shared_memory") is None:
            pytest.skip("no shared_memory on this platform")
        from tensorflowonspark_tpu_torch import tfrecord

        shard = str(tmp_path / "part-00000")
        with tfrecord.TFRecordWriter(shard) as w:
            for i in range(16):
                w.write(str(i).encode())

        plan = chaos.ChaosPlan(seed=11).site(
            "data.decode_kill", probability=1.0, max_count=1
        )
        chaos.install(plan)  # propagate=True: children inherit via env
        cluster = TFCluster.run(
            sc, fn_decode_plane_under_chaos, {"shard": shard}, num_executors=2,
            input_mode=InputMode.SPARK, master_node=None,
            env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
        )
        try:
            # every child's stream survived the worker kill intact
            results = cluster.inference(sc.parallelize(range(8), 4)).collect()
            assert results == [1] * 8

            # child counters arrive on the SnapshotPublisher interval
            deadline = time.monotonic() + 60
            while True:
                snap = cluster.metrics()
                counters = snap["counters"]
                kills = (
                    counters.get("chaos_fault_data_decode_kill_total", {})
                    .get("value", 0)
                )
                restarts = (
                    counters.get("decode_worker_restarts_total", {})
                    .get("value", 0)
                )
                if (kills >= 1 and restarts >= 1) or time.monotonic() > deadline:
                    break
                time.sleep(0.5)
            assert kills >= 1
            assert restarts >= 1
        finally:
            cluster.shutdown(timeout=120)
