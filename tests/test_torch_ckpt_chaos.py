"""Chaos against the async checkpoint engine.

The acceptance bar: with a chaos-delayed write in flight
the training loop keeps stepping (overlap leg, also a ``perf_smoke``
marker), and a ``ckpt.commit_tear`` mid-commit never corrupts what
``restore_latest`` returns — either the staging dir is left unpublished or
the published dir fails cheap-verify and is skipped with a logged reason.
The cluster leg reruns the tear inside a spawned trainer child and asserts the
fault is visible in the merged ``TFCluster.metrics()`` snapshot."""

import logging
import os
import random
import time

import numpy as np
import pytest

from tensorflowonspark_tpu_torch import chaos, ckpt, obs, util
from tensorflowonspark_tpu_torch.ckpt.snapshot import snapshot_to_host
from tensorflowonspark_tpu_torch.train import checkpoint

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.uninstall()
    yield
    chaos.uninstall()


def _state(step):
    return {"step": np.int64(step), "w": np.full(8, float(step), np.float32)}


def _seed_firing_on_nth(site, n, probability):
    """Find a plan seed whose RNG for ``site`` stays quiet for the first
    ``n - 1`` arrivals and fires on the n-th — the same
    ``random.Random("{seed}:{site}")`` stream ChaosPlan rolls, so the
    schedule reproduces in any process the plan propagates to."""
    for seed in range(10000):
        rng = random.Random("{}:{}".format(seed, site))
        draws = [rng.random() for _ in range(n)]
        if all(d >= probability for d in draws[:-1]) and draws[-1] < probability:
            return seed
    raise AssertionError("no seed fires {} on arrival {}".format(site, n))


def _save_async(model_dir, steps, **engine_kw):
    with ckpt.AsyncCheckpointEngine(model_dir, **engine_kw) as eng:
        for step in steps:
            eng.save(_state(step), step)
            assert eng.drain(timeout=60)


class TestCorruptWriteAsync:
    def test_bitrot_after_manifest_is_caught_by_cheap_verify(self, tmp_path, caplog):
        model_dir = str(tmp_path)
        _save_async(model_dir, [1])
        chaos.install(
            chaos.ChaosPlan(seed=0).site("checkpoint.corrupt_write",
                                         probability=1.0, max_count=1),
            propagate=False,
        )
        _save_async(model_dir, [2])
        chaos.uninstall()

        # the torn checkpoint PUBLISHED (bitrot hit after the manifest) but
        # cheap-verify rejects it without attempting a restore
        assert os.path.isdir(os.path.join(model_dir, "ckpt_2"))
        ok, reason = ckpt.verify(os.path.join(model_dir, "ckpt_2"))
        assert not ok and ("mismatch" in reason or "torn" in reason or
                           "missing" in reason)
        with caplog.at_level(logging.WARNING,
                             logger="tensorflowonspark_tpu_torch.train.checkpoint"):
            state, path = checkpoint.restore_latest(model_dir)
        assert os.path.basename(path) == "ckpt_1"
        np.testing.assert_array_equal(state["w"], np.full(8, 1.0, np.float32))
        joined = " ".join(r.getMessage() for r in caplog.records)
        assert "skipping checkpoint" in joined and "ckpt_2" in joined


class TestCommitTear:
    def test_tear_leaves_staging_unpublished(self, tmp_path):
        model_dir = str(tmp_path)
        _save_async(model_dir, [1])
        chaos.install(
            chaos.ChaosPlan(seed=0).site("ckpt.commit_tear",
                                         probability=1.0, max_count=1),
            propagate=False,
        )
        _save_async(model_dir, [2])
        chaos.uninstall()

        # crash-before-rename shape: staging left behind, never published
        assert os.path.isdir(os.path.join(model_dir, "tmp.ckpt_2"))
        assert not os.path.isdir(os.path.join(model_dir, "ckpt_2"))
        state, path = checkpoint.restore_latest(model_dir)
        assert os.path.basename(path) == "ckpt_1"

        # a retried save for the same step sweeps the stale staging dir
        _save_async(model_dir, [2])
        assert not os.path.isdir(os.path.join(model_dir, "tmp.ckpt_2"))
        state, path = checkpoint.restore_latest(model_dir)
        assert os.path.basename(path) == "ckpt_2"
        np.testing.assert_array_equal(state["w"], np.full(8, 2.0, np.float32))

    def test_publish_torn_manifest_is_skipped_with_reason(self, tmp_path, caplog):
        model_dir = str(tmp_path)
        _save_async(model_dir, [1])
        chaos.install(
            chaos.ChaosPlan(seed=0).site("ckpt.commit_tear", probability=1.0,
                                         max_count=1, publish_torn=True),
            propagate=False,
        )
        _save_async(model_dir, [2])
        chaos.uninstall()

        # the rename happened over a half-written manifest
        assert os.path.isdir(os.path.join(model_dir, "ckpt_2"))
        ok, reason = ckpt.verify(os.path.join(model_dir, "ckpt_2"))
        assert not ok and "torn manifest" in reason
        with caplog.at_level(logging.WARNING,
                             logger="tensorflowonspark_tpu_torch.train.checkpoint"):
            state, path = checkpoint.restore_latest(model_dir)
        assert os.path.basename(path) == "ckpt_1"
        joined = " ".join(r.getMessage() for r in caplog.records)
        assert "torn manifest" in joined
        assert "after skipping 1 newer checkpoint" in joined


class TestSupersede:
    def test_newer_snapshot_replaces_queued_one(self, tmp_path):
        model_dir = str(tmp_path)
        before = obs.counter("ckpt_superseded_total").value
        # one slow write pins the writer; saves 2 and 3 arrive while it is
        # busy, so 2 waits in the hand-off slot and 3 replaces it
        plan = chaos.ChaosPlan(seed=0).site("ckpt.write_slow", probability=1.0,
                                            max_count=1, delay_s=0.5)
        chaos.install(plan, propagate=False)
        with ckpt.AsyncCheckpointEngine(model_dir) as eng:
            eng.save(_state(1), 1)
            # the fault fires inside the writer's timed region, so fired()
            # flipping proves step 1 was dequeued (not just pending) and the
            # writer is sitting in its 0.5 s stall
            deadline = time.monotonic() + 30
            while not plan.fired("ckpt.write_slow") and time.monotonic() < deadline:
                time.sleep(0.005)
            assert plan.fired("ckpt.write_slow") == 1
            eng.save(_state(2), 2)
            eng.save(_state(3), 3)
            assert eng.drain(timeout=60)
        chaos.uninstall()

        assert sorted(os.listdir(model_dir)) == ["ckpt_1", "ckpt_3"]
        assert obs.counter("ckpt_superseded_total").value == before + 1
        state, path = checkpoint.restore_latest(model_dir)
        assert os.path.basename(path) == "ckpt_3"


class TestSnapshotStall:
    def test_stall_is_charged_to_the_snapshot_counter(self):
        plan = chaos.ChaosPlan(seed=0).site("ckpt.snapshot_stall",
                                            probability=1.0, max_count=1,
                                            delay_s=0.05)
        chaos.install(plan, propagate=False)
        before = obs.counter("ckpt_snapshot_seconds_total").value
        snap = snapshot_to_host(_state(1), step=1)
        chaos.uninstall()
        assert plan.fired("ckpt.snapshot_stall") == 1
        np.testing.assert_array_equal(snap.tree["w"], np.full(8, 1.0, np.float32))
        # the injected stall lands inside the timed snapshot region
        assert obs.counter("ckpt_snapshot_seconds_total").value - before >= 0.05


@pytest.mark.perf_smoke
class TestOverlap:
    def test_training_steps_continue_while_write_is_in_flight(self, tmp_path):
        model_dir = str(tmp_path)
        delay_s = 1.0
        chaos.install(
            chaos.ChaosPlan(seed=0).site("ckpt.write_slow", probability=1.0,
                                         max_count=1, delay_s=delay_s),
            propagate=False,
        )
        with ckpt.AsyncCheckpointEngine(model_dir) as eng:
            state = _state(0)
            eng.save(state, 1)
            t0 = time.monotonic()
            for _ in range(20):  # the training loop keeps stepping
                state = {"step": state["step"] + 1, "w": state["w"] + 1.0}
            stepped = time.monotonic() - t0
            # the save is still in flight (the writer is inside its chaos
            # delay) yet 20 steps cost nowhere near the write stall
            assert eng.drain(timeout=0.05) is False
            assert stepped < delay_s / 2
            assert eng.drain(timeout=60)
            assert eng.error is None
        chaos.uninstall()
        assert ckpt.verify(os.path.join(model_dir, "ckpt_1")) == (True, "verified")


# -- cluster leg --------------------------------------------------------------

CPU_ENV = {util.ENV_PLATFORM: "cpu"}
TEAR_PROBABILITY = 0.5


def fn_train_with_async_ckpt(args, ctx):
    """Runs in the spawned trainer child: two async saves under the propagated
    plan (the second commit tears), then serves the feed so the metrics
    publisher has time to ship the child's counters to the driver."""
    import numpy as np

    from tensorflowonspark_tpu_torch import chaos as _chaos
    from tensorflowonspark_tpu_torch import ckpt as _ckpt

    assert _chaos.active, "chaos plan did not reach the trainer child"
    with _ckpt.AsyncCheckpointEngine(args["model_dir"]) as eng:
        for step in (1, 2):
            eng.save(
                {"step": np.int64(step), "w": np.full(8, float(step), np.float32)},
                step,
            )
            assert eng.drain(timeout=120)
    feed = ctx.get_data_feed(train_mode=False)
    while not feed.should_stop():
        batch = feed.next_batch(16)
        if batch:
            feed.batch_results([x + 1 for x in batch])


class TestClusterCommitTear:
    def test_tear_in_child_surfaces_in_metrics_and_restore_prefers_good(
        self, tmp_path
    ):
        from tensorflowonspark_tpu_torch import TFCluster
        from tensorflowonspark_tpu_torch.TFCluster import InputMode
        from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext

        model_dir = str(tmp_path / "model")
        # seed-searched so the tear skips the step-1 commit and hits the
        # step-2 commit — deterministic across processes because each site
        # draws from random.Random("{seed}:{site}")
        seed = _seed_firing_on_nth("ckpt.commit_tear", 2, TEAR_PROBABILITY)
        plan = chaos.ChaosPlan(seed=seed).site(
            "ckpt.commit_tear", probability=TEAR_PROBABILITY, max_count=1
        )
        chaos.install(plan)  # propagate=True: the child inherits via env

        sc = LocalSparkContext(num_executors=1, task_timeout=120)
        cluster = TFCluster.run(
            sc, fn_train_with_async_ckpt, {"model_dir": model_dir},
            num_executors=1, input_mode=InputMode.SPARK, master_node=None,
            env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
        )
        try:
            # the child finished its saves and answers the feed
            results = cluster.inference(sc.parallelize(range(20), 2)).collect()
            assert sorted(results) == list(range(1, 21))

            # the child's fault + commit counters cross the merge lane on
            # the SnapshotPublisher interval
            deadline = time.monotonic() + 60
            while True:
                snap = cluster.metrics()
                counters = snap["counters"]
                tears = counters.get(
                    "chaos_fault_ckpt_commit_tear_total", {}).get("value", 0)
                if tears >= 1 or time.monotonic() > deadline:
                    break
                time.sleep(0.5)
            assert counters["chaos_fault_ckpt_commit_tear_total"]["value"] >= 1
            assert counters["ckpt_commits_total"]["value"] >= 1
            assert counters["ckpt_bytes_total"]["value"] > 0
        finally:
            cluster.shutdown(timeout=120)
            sc.stop()

        # driver-side resume: step 2's commit tore before publish, so the
        # newest restorable checkpoint is the step-1 one
        assert os.path.isdir(os.path.join(model_dir, "tmp.ckpt_2"))
        state, path = checkpoint.restore_latest(model_dir)
        assert os.path.basename(path) == "ckpt_1"
        assert int(state["step"]) == 1
