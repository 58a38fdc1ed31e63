"""Control-plane chaos tests: a mid-train driver
crash recovers the membership registry from its journal — live executors
re-adopted, zero relaunches, epoch bumped — and benign lease-renewal
latency never expires a healthy lease. All asserted from the merged
``TFCluster.metrics()`` snapshot."""

import os
import time

import pytest

from tensorflowonspark_tpu_torch import TFCluster, chaos, util
from tensorflowonspark_tpu_torch import registry as membership
from tensorflowonspark_tpu_torch.TFCluster import InputMode
from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
from tensorflowonspark_tpu_torch.obs import registry as obs_registry

CPU_ENV = {util.ENV_PLATFORM: "cpu"}


def fn_sleep_forever(args, ctx):
    feed = ctx.get_data_feed(train_mode=False)
    while not feed.should_stop():
        feed.next_batch(16)


def _wait_for_counter(cluster, name, at_least, within_secs):
    deadline = time.time() + within_secs
    snap = None
    while time.time() < deadline:
        snap = cluster.metrics()
        c = (snap.get("counters") or {}).get(name)
        if c is not None and c["value"] >= at_least:
            return snap
        time.sleep(1.0)
    return snap


@pytest.mark.chaos
@pytest.mark.slow
def test_driver_crash_recovers_registry_without_relaunch(tmp_path, monkeypatch):
    """``control.driver_crash`` drops the registry mid-watch with no parting
    commit — and ``control.journal_tear`` has already torn the manifest
    publish, so recovery must detect the CRC mismatch and rebuild from the
    journal. The restarted registry re-adopts every live lease (no
    relaunch, no recovery-ladder rung), fences the old epoch, and the
    cluster keeps feeding and shuts down cleanly."""
    monkeypatch.setenv("TOS_MONITOR_INTERVAL", "1")
    chaos_log = str(tmp_path / "chaos.log")
    monkeypatch.setenv(chaos.LOG_ENV_VAR, chaos_log)
    registry_dir = str(tmp_path / "registry")

    plan = (
        chaos.ChaosPlan(seed=3)
        .site("control.journal_tear", probability=1.0, max_count=1)
        .site("control.driver_crash", probability=1.0, max_count=1)
    )
    chaos.install(plan)
    sc = LocalSparkContext(num_executors=2, task_timeout=240)
    try:
        cluster = TFCluster.run(
            sc, fn_sleep_forever, {}, num_executors=2,
            input_mode=InputMode.SPARK, master_node=None,
            env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
            registry_dir=registry_dir,
        )
        snap = _wait_for_counter(
            cluster, "registry_driver_restarts_total", at_least=1, within_secs=60
        )
        assert snap["counters"]["registry_driver_restarts_total"]["value"] == 1

        # the crash was survivable: every lease re-adopted, nothing relaunched
        assert cluster.tf_status.get("error") is None
        assert snap["gauges"]["registry_leases_active"]["value"] == 2
        assert snap["counters"].get("recovery_attempts_total") is None
        assert snap["counters"].get("recovery_shrinks_total") is None
        # a recovered registry always runs at a HIGHER epoch than the
        # generation it replaced (begin_generation -> 1, recover -> >= 2)
        assert snap["gauges"]["registry_epoch"]["value"] >= 2
        assert cluster.registry.epoch >= 2

        # the journal on disk is the recovered truth: a fresh replay agrees
        replayed = membership.MembershipRegistry.recover(registry_dir)
        assert sorted(replayed.members()) == [0, 1]

        # still a working cluster after the restart: feed a wave through it
        cluster.train(sc.parallelize(range(64), 2), num_epochs=1, feed_timeout=60)
        assert cluster.tf_status.get("error") is None
        cluster.shutdown(timeout=120)
    finally:
        sc.stop()
        chaos.uninstall()

    with open(chaos_log) as f:
        fired = [line.strip() for line in f]
    assert "control.driver_crash" in fired
    assert "control.journal_tear" in fired


@pytest.mark.chaos
@pytest.mark.slow
def test_lease_delay_is_benign(tmp_path, monkeypatch):
    """``control.lease_delay`` injects latency into lease renewal; healthy
    leases must ride it out — no expiries, no watchdog error."""
    monkeypatch.setenv("TOS_MONITOR_INTERVAL", "1")
    chaos_log = str(tmp_path / "chaos.log")
    monkeypatch.setenv(chaos.LOG_ENV_VAR, chaos_log)

    plan = chaos.ChaosPlan(seed=5).site(
        "control.lease_delay", probability=0.5, max_count=None, delay_s=0.01
    )
    chaos.install(plan)
    # the expiration counter lives in the process-global obs registry, so
    # earlier tests in the same process may already have bumped it: assert
    # the DELTA over this cluster's lifetime, not the absolute value
    expirations_before = obs_registry.counter("registry_lease_expirations_total").value
    sc = LocalSparkContext(num_executors=2, task_timeout=240)
    try:
        cluster = TFCluster.run(
            sc, fn_sleep_forever, {}, num_executors=2,
            input_mode=InputMode.SPARK, master_node=None,
            env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
        )
        cluster.train(sc.parallelize(range(64), 2), num_epochs=1, feed_timeout=60)
        time.sleep(5)  # a few watchdog ticks under injected renewal latency
        snap = cluster.metrics()
        assert cluster.tf_status.get("error") is None
        expirations = (snap["counters"].get("registry_lease_expirations_total") or {}).get(
            "value", 0
        )
        assert expirations == expirations_before
        assert snap["gauges"]["registry_leases_active"]["value"] == 2
        cluster.shutdown(timeout=120)
    finally:
        sc.stop()
        chaos.uninstall()

    assert plan.fired("control.lease_delay") >= 1
    with open(chaos_log) as f:
        assert any(line.strip() == "control.lease_delay" for line in f)
