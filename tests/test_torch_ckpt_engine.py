"""The async checkpoint engine: snapshot, background commit, loop hook.

Chaos-free unit coverage (the fault-injection legs live in
tests/test_ckpt_chaos.py): commits publish manifest-verified checkpoints,
``run_steps`` drives the ``save_every_n`` cadence and drains on exit, the
snapshot pool double-buffers, and pruning honors the in-flight registry."""

import os

import numpy as np
import pytest

from tensorflowonspark_tpu_torch import ckpt, obs
from tensorflowonspark_tpu_torch.ckpt.snapshot import SnapshotBuffers, snapshot_to_host
from tensorflowonspark_tpu_torch.train import checkpoint
from tensorflowonspark_tpu_torch.train.strategy import run_steps


def _state(step):
    return {"step": np.int64(step), "w": np.full(16, float(step), np.float32)}


class TestEngineCommit:
    def test_save_publishes_manifest_verified_checkpoint(self, tmp_path):
        d = str(tmp_path)
        with ckpt.AsyncCheckpointEngine(d) as eng:
            eng.save(_state(3), 3)
            assert eng.drain(timeout=60)
        assert sorted(os.listdir(d)) == ["ckpt_3"]
        assert ckpt.verify(os.path.join(d, "ckpt_3")) == (True, "verified")
        state, path = checkpoint.restore_latest(d)
        assert os.path.basename(path) == "ckpt_3"
        np.testing.assert_array_equal(state["w"], np.full(16, 3.0, np.float32))
        assert eng.error is None

    def test_sequential_saves_keep_prune_budget(self, tmp_path):
        d = str(tmp_path)
        with ckpt.AsyncCheckpointEngine(d, keep=2) as eng:
            for step in (1, 2, 3, 4):
                eng.save(_state(step), step)
                assert eng.drain(timeout=60)
        assert sorted(os.listdir(d)) == ["ckpt_3", "ckpt_4"]

    def test_resave_same_step_replaces(self, tmp_path):
        d = str(tmp_path)
        with ckpt.AsyncCheckpointEngine(d) as eng:
            eng.save(_state(7), 7)
            assert eng.drain(timeout=60)
            eng.save({"step": np.int64(7), "w": np.full(16, 99.0, np.float32)}, 7)
        state, _ = checkpoint.restore_latest(d)
        np.testing.assert_array_equal(state["w"], np.full(16, 99.0, np.float32))

    def test_save_after_close_raises(self, tmp_path):
        eng = ckpt.AsyncCheckpointEngine(str(tmp_path))
        eng.close()
        with pytest.raises(RuntimeError):
            eng.save(_state(1), 1)
        eng.close()  # idempotent

    def test_counters_flow(self, tmp_path):
        before_bytes = obs.counter("ckpt_bytes_total").value
        before_commits = obs.counter("ckpt_commits_total").value
        with ckpt.AsyncCheckpointEngine(str(tmp_path)) as eng:
            eng.save(_state(1), 1)
        assert obs.counter("ckpt_bytes_total").value > before_bytes
        assert obs.counter("ckpt_commits_total").value == before_commits + 1
        assert obs.counter("ckpt_snapshot_seconds_total").value >= 0
        assert obs.gauge("ckpt_pending").value == 0  # drained by close()


class TestRunStepsHook:
    def test_save_every_n_cadence_and_drain_on_exit(self, tmp_path):
        d = str(tmp_path)

        def step_fn(state, batch):
            new = {"step": state["step"] + 1, "w": state["w"] + batch}
            return new, {"loss": float(new["w"][0])}

        eng = ckpt.AsyncCheckpointEngine(d, save_every_n=2)
        state, metrics = run_steps(
            step_fn, _state(0), [np.float32(1.0)] * 5, engine=eng
        )
        # cadence queued saves at steps 2 and 4; drain-on-exit guarantees the
        # NEWEST one is published (step 2's may be superseded if the toy loop
        # outruns the writer — that is the newest-wins contract, not a loss)
        assert eng.saves_accepted == 2
        assert "ckpt_4" in os.listdir(d)
        assert set(os.listdir(d)) <= {"ckpt_2", "ckpt_4"}
        assert metrics["loss"] == 5.0
        restored, path = checkpoint.restore_latest(d)
        assert os.path.basename(path) == "ckpt_4"
        np.testing.assert_array_equal(restored["w"], np.full(16, 4.0, np.float32))
        eng.close()

    def test_explicit_cadence_overrides_engine(self, tmp_path):
        d = str(tmp_path)

        def step_fn(state, batch):
            return {"step": state["step"] + 1, "w": state["w"]}, {}

        with ckpt.AsyncCheckpointEngine(d, save_every_n=1) as eng:
            run_steps(step_fn, _state(0), [None] * 4, engine=eng, save_every_n=4)
        assert sorted(os.listdir(d)) == ["ckpt_4"]

    def test_hooks_see_global_step(self, tmp_path):
        seen = []

        def step_fn(state, batch):
            return {"step": state["step"] + 1, "w": state["w"]}, {"loss": 0.0}

        run_steps(
            step_fn, _state(10), [None] * 3,
            hooks=[lambda s, step, m: seen.append(step)],
        )
        assert seen == [11, 12, 13]

    def test_drain_on_error_exit(self, tmp_path):
        d = str(tmp_path)

        def step_fn(state, batch):
            if batch == "boom":
                raise ValueError("boom")
            return {"step": state["step"] + 1, "w": state["w"]}, {}

        with ckpt.AsyncCheckpointEngine(d, save_every_n=1) as eng:
            with pytest.raises(ValueError):
                run_steps(step_fn, _state(0), [None, "boom"], engine=eng)
        # the step-1 save landed even though the loop died on step 2
        assert sorted(os.listdir(d)) == ["ckpt_1"]


class TestSnapshotBuffers:
    def test_snapshot_owns_its_memory(self):
        src = {"w": np.arange(8, dtype=np.float32)}
        snap = snapshot_to_host(src, step=1)
        src["w"][:] = -1.0  # donation-equivalent: source reused immediately
        np.testing.assert_array_equal(
            snap.tree["w"], np.arange(8, dtype=np.float32)
        )

    def test_slot_reuse_after_release(self):
        pool = SnapshotBuffers(depth=2)
        a = pool.take(_state(1))
        buf_a = a.tree["w"]
        pool.release(a)
        b = pool.take(_state(2))
        assert b.tree["w"] is buf_a  # pooled buffer reused, no realloc
        np.testing.assert_array_equal(b.tree["w"], np.full(16, 2.0, np.float32))

    def test_overflow_beyond_depth_is_unpooled(self):
        pool = SnapshotBuffers(depth=2)
        held = [pool.take(_state(i)) for i in range(3)]
        assert held[0].slot is not None and held[1].slot is not None
        assert held[2].slot is None  # overflow: fresh unpooled buffers
        for snap in held:
            pool.release(snap)

    def test_shape_change_evicts_stale_slots(self):
        pool = SnapshotBuffers(depth=1)
        a = pool.take({"w": np.zeros(4, np.float32)})
        pool.release(a)
        b = pool.take({"w": np.zeros(8, np.float32)})  # new signature
        assert b.slot is not None  # stale slot evicted, pooled slot granted
        assert b.tree["w"].shape == (8,)
        pool.release(b)


class TestPruneInFlightGuard:
    def test_explicit_in_flight_survives_prune(self, tmp_path):
        d = str(tmp_path)
        for step in (1, 2, 3):
            checkpoint.save_checkpoint(os.path.join(d, "ckpt_{}".format(step)),
                                       {"step": step, "w": [float(step)] * 4})
        removed = checkpoint.prune_checkpoints(
            d, keep=1, in_flight={os.path.join(d, "ckpt_1")}
        )
        assert removed == 1  # only ckpt_2: ckpt_1 is mid-commit, ckpt_3 kept
        assert sorted(os.listdir(d)) == ["ckpt_1", "ckpt_3"]

    def test_tmp_staging_dirs_invisible_everywhere(self, tmp_path):
        d = str(tmp_path)
        checkpoint.save_checkpoint(os.path.join(d, "ckpt_2"),
                                   {"step": 2, "w": [2.0] * 4})
        os.makedirs(os.path.join(d, "tmp.ckpt_5"))  # torn commit leftover
        assert checkpoint.latest_checkpoint(d).endswith("ckpt_2")
        # even the any-layout escape hatch must not resurrect staging dirs
        assert checkpoint.latest_checkpoint(d, prefix="").endswith("ckpt_2")
        assert checkpoint.prune_checkpoints(d, keep=1) == 0
        assert os.path.isdir(os.path.join(d, "tmp.ckpt_5"))

    def test_engine_registry_feeds_default_guard(self, tmp_path):
        eng = ckpt.AsyncCheckpointEngine(str(tmp_path))
        try:
            assert eng.busy_paths() == set()
            assert ckpt.in_flight_paths() == set()
            eng.save(_state(1), 1)
            eng.drain(timeout=60)
            assert ckpt.in_flight_paths() == set()
        finally:
            eng.close()
