"""Mid-run failure watchdog tests: a crashed child
surfaces on the driver within seconds — via the error queue for a clean
traceback, via heartbeat loss for a SIGKILLed child — not only at shutdown."""

import os
import time

import pytest

from tensorflowonspark_tpu_torch import TFCluster, elastic, util
from tensorflowonspark_tpu_torch.TFCluster import InputMode
from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext

CPU_ENV = {util.ENV_PLATFORM: "cpu"}


def fn_sleep_forever(args, ctx):
    feed = ctx.get_data_feed(train_mode=False)
    while not feed.should_stop():
        feed.next_batch(16)


def fn_crash_after_start(args, ctx):
    if ctx.executor_id == args["victim"]:
        time.sleep(1.0)
        raise RuntimeError("deliberate mid-run crash")
    feed = ctx.get_data_feed(train_mode=False)
    while not feed.should_stop():
        feed.next_batch(16)


def fn_sigkill_self(args, ctx):
    import signal

    if ctx.executor_id == args["victim"]:
        time.sleep(1.0)
        os.kill(os.getpid(), signal.SIGKILL)  # no traceback, no child_status
    feed = ctx.get_data_feed(train_mode=False)
    while not feed.should_stop():
        feed.next_batch(16)


def _wait_for_error(cluster, within_secs):
    deadline = time.time() + within_secs
    while time.time() < deadline:
        if cluster.tf_status.get("error"):
            return cluster.tf_status["error"]
        time.sleep(0.5)
    return None


@pytest.mark.slow
def test_watchdog_surfaces_crash_mid_run(monkeypatch):
    monkeypatch.setenv("TOS_MONITOR_INTERVAL", "1")
    sc = LocalSparkContext(num_executors=2, task_timeout=240)
    try:
        cluster = TFCluster.run(
            sc, fn_crash_after_start, {"victim": 1}, num_executors=2,
            input_mode=InputMode.SPARK, master_node=None,
            env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
        )
        err = _wait_for_error(cluster, within_secs=60)
        assert err is not None and "deliberate mid-run crash" in err
        with pytest.raises(RuntimeError, match="deliberate mid-run crash"):
            cluster.check_errors()
        with pytest.raises(RuntimeError, match="deliberate mid-run crash"):
            cluster.shutdown(timeout=60)
    finally:
        sc.stop()


@pytest.mark.slow
def test_watchdog_detects_silent_child_death(monkeypatch):
    """SIGKILL leaves no traceback and no child_status; the heartbeat gap is
    the only signal."""
    monkeypatch.setenv("TOS_MONITOR_INTERVAL", "1")
    monkeypatch.setenv("TOS_HEARTBEAT_STALE", "6")
    sc = LocalSparkContext(num_executors=2, task_timeout=240)
    try:
        cluster = TFCluster.run(
            sc, fn_sigkill_self, {"victim": 1}, num_executors=2,
            input_mode=InputMode.SPARK, master_node=None,
            env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
        )
        err = _wait_for_error(cluster, within_secs=90)
        assert err is not None and "stopped heartbeating" in err
        with pytest.raises(RuntimeError, match="stopped heartbeating"):
            cluster.shutdown(timeout=60)
    finally:
        sc.stop()


@pytest.mark.slow
def test_lease_expiry_names_the_executor_for_the_ledger(monkeypatch):
    """A node that stops renewing its lease surfaces as
    a first-class ``lease_expired`` event carrying the executor id inline —
    so ``FailureLedger.suspects()`` attributes it without a role_map — and
    the registry's lease metrics land in the merged ``cluster.metrics()``."""
    monkeypatch.setenv("TOS_MONITOR_INTERVAL", "1")
    monkeypatch.setenv("TOS_HEARTBEAT_STALE", "6")
    sc = LocalSparkContext(num_executors=2, task_timeout=240)
    try:
        cluster = TFCluster.run(
            sc, fn_sigkill_self, {"victim": 1}, num_executors=2,
            input_mode=InputMode.SPARK, master_node=None,
            env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
        )
        err = _wait_for_error(cluster, within_secs=90)
        assert err is not None and "lease expired" in err

        event = elastic.classify_failure(RuntimeError(err))
        assert event.kind == "lease_expired"
        assert event.executor_ids == [1]
        assert event.kind in elastic.LOSS_KINDS

        ledger = elastic.FailureLedger(max_restarts=8, blacklist_after=2)
        ledger.record(event)
        ledger.record(event)
        assert ledger.suspects() == [1]

        snap = cluster.metrics()
        assert snap["counters"]["registry_lease_expirations_total"]["value"] >= 1
        assert snap["gauges"]["registry_epoch"]["value"] >= 1

        with pytest.raises(RuntimeError, match="lease expired"):
            cluster.shutdown(timeout=60)
    finally:
        sc.stop()


def test_healthy_cluster_watchdog_stays_quiet():
    sc = LocalSparkContext(num_executors=1, task_timeout=240)
    try:
        cluster = TFCluster.run(
            sc, fn_sleep_forever, {}, num_executors=1,
            input_mode=InputMode.SPARK, master_node=None,
            env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
        )
        cluster.train(sc.parallelize(range(64), 2), num_epochs=1, feed_timeout=60)
        assert cluster.tf_status.get("error") is None
        cluster.check_errors()  # no-op on a healthy cluster
        cluster.shutdown(timeout=120)
    finally:
        sc.stop()
