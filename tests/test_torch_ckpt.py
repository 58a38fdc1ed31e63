"""The port's checkpoint package on the CPU: the contracts of the JAX
package's ``test_ckpt_manifest.py``, ``test_ckpt_engine.py``,
``test_ckpt_chaos.py`` and ``test_chaos_checkpoint.py``, re-asserted on
``tensorflowonspark_tpu_torch.ckpt`` and ``train.checkpoint``.

The manifest's verify round-trip and every reject reason; the engine's
commit, supersede, drain on exit and on error, the ``run_steps`` cadence;
the snapshot pool; the prune in-flight guard and invisible staging dirs;
torn, bitrotten and failing restores falling back with a logged reason; an
empty directory as a fresh start; the prefix warnings; and a commit torn
inside a trainer child of the port's ``TFCluster``. States are trees of
torch tensors (a numpy leaf is copied into a tensor)."""

import json
import logging
import os
import random
import time

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import TFSparkNode, chaos, ckpt, obs, util
from tensorflowonspark_tpu_torch.ckpt import manifest
from tensorflowonspark_tpu_torch.ckpt.snapshot import SnapshotBuffers, snapshot_to_host
from tensorflowonspark_tpu_torch.train import SyncDataParallel, TrainState, checkpoint, optim
from tensorflowonspark_tpu_torch.train.strategy import run_steps

CPU_ENV = {util.ENV_PLATFORM: "cpu"}
LOGGER = "tensorflowonspark_tpu_torch.train.checkpoint"


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.uninstall()
    yield
    chaos.uninstall()


def _state(step, value=None):
    return {"step": step, "w": torch.full((16,), float(step if value is None else value))}


def _save_steps(model_dir, steps):
    for step in steps:
        checkpoint.save_checkpoint(os.path.join(model_dir, "ckpt_{}".format(step)), _state(step))


def _save_async(model_dir, steps, **engine_kw):
    with ckpt.AsyncCheckpointEngine(model_dir, **engine_kw) as eng:
        for step in steps:
            eng.save(_state(step), step)
            assert eng.drain(timeout=60)


def _arm(site, **spec):
    plan = chaos.ChaosPlan(seed=0).site(site, **spec)
    chaos.install(plan, propagate=False)
    return plan


# -- manifest ----------------------------------------------------------------


def _make_files(root, files):
    os.makedirs(root, exist_ok=True)
    for rel, payload in files.items():
        sub = os.path.join(root, rel)
        os.makedirs(os.path.dirname(sub), exist_ok=True)
        with open(sub, "wb") as f:
            f.write(payload)


def test_manifest_roundtrip_verifies_and_records_step_and_extra(tmp_path):
    root = str(tmp_path / "ckpt_1")
    _make_files(root, {"a.bin": b"hello", "sub/b.bin": b"world" * 100})
    m = manifest.write_manifest(root, step=1, extra={"world": 2})
    assert set(m["files"]) == {"a.bin", os.path.join("sub", "b.bin")}
    assert m["files"]["a.bin"]["size"] == 5
    assert manifest.verify(root) == (True, "verified")
    manifest.write_manifest(root, step=1, extra={"world": 2})  # idempotent rewrite
    names = os.listdir(root)
    assert manifest.MANIFEST_NAME in names and not any(n.endswith(".tmp") for n in names)
    read = manifest.read_manifest(root)
    assert read["step"] == 1 and read["extra"] == {"world": 2}
    assert manifest.MANIFEST_NAME not in read["files"]


def _missing(root):
    os.remove(os.path.join(root, "b.bin"))


def _grown(root):
    with open(os.path.join(root, "a.bin"), "ab") as f:
        f.write(b"tail")


def _flipped(root):
    with open(os.path.join(root, "a.bin"), "r+b") as f:
        f.write(b"Z")  # flip bytes, keep the size


def _torn_manifest(root):
    mpath = os.path.join(root, manifest.MANIFEST_NAME)
    with open(mpath, "r+b") as f:
        f.truncate(os.path.getsize(mpath) // 2)


def _no_table(root):
    with open(os.path.join(root, manifest.MANIFEST_NAME), "w") as f:
        json.dump({"version": 1}, f)


@pytest.mark.parametrize("damage, reason", [
    (_missing, "missing file b.bin"), (_grown, "size mismatch on a.bin"),
    (_flipped, "checksum mismatch on a.bin"), (_torn_manifest, "torn manifest"),
    (_no_table, "no file table"),
])
def test_manifest_rejects_with_reason(tmp_path, damage, reason):
    root = str(tmp_path / "ckpt_9")
    _make_files(root, {"a.bin": b"A" * 64, "b.bin": b"B" * 64})
    manifest.write_manifest(root, step=9)
    damage(root)
    ok, got = manifest.verify(root)
    assert not ok and reason in got


def test_manifest_less_dir_is_legacy_ok(tmp_path):
    root = str(tmp_path / "old")
    _make_files(root, {"a.bin": b"x"})
    assert manifest.verify(root) == (True, "no manifest")
    assert manifest.read_manifest(root) is None


# -- engine ------------------------------------------------------------------


def test_engine_publishes_a_manifest_verified_checkpoint(tmp_path):
    d = str(tmp_path)
    with ckpt.AsyncCheckpointEngine(d) as eng:
        eng.save(_state(3), 3)
        assert eng.drain(timeout=60)
    assert sorted(os.listdir(d)) == ["ckpt_3"]
    assert ckpt.verify(os.path.join(d, "ckpt_3")) == (True, "verified")
    assert sorted(os.listdir(os.path.join(d, "ckpt_3"))) == [manifest.MANIFEST_NAME, checkpoint.STATE_FILE]
    state, path = checkpoint.restore_latest(d)
    assert os.path.basename(path) == "ckpt_3" and state["step"] == 3
    assert torch.equal(state["w"], torch.full((16,), 3.0))
    assert eng.error is None


def test_engine_keeps_the_prune_budget_and_replaces_a_resaved_step(tmp_path):
    d = str(tmp_path)
    _save_async(d, [1, 2, 3, 4], keep=2)
    assert sorted(os.listdir(d)) == ["ckpt_3", "ckpt_4"]
    with ckpt.AsyncCheckpointEngine(d) as eng:
        eng.save(_state(4, value=99.0), 4)
    state, _ = checkpoint.restore_latest(d)
    assert torch.equal(state["w"], torch.full((16,), 99.0))


def test_engine_save_after_close_raises(tmp_path):
    eng = ckpt.AsyncCheckpointEngine(str(tmp_path))
    eng.close()
    with pytest.raises(RuntimeError):
        eng.save(_state(1), 1)
    eng.close()  # idempotent


def test_engine_counters_flow(tmp_path):
    before_bytes = obs.counter("ckpt_bytes_total").value
    before_commits = obs.counter("ckpt_commits_total").value
    with ckpt.AsyncCheckpointEngine(str(tmp_path)) as eng:
        eng.save(_state(1), 1)
    assert obs.counter("ckpt_bytes_total").value == before_bytes + 16 * 4
    assert obs.counter("ckpt_commits_total").value == before_commits + 1
    assert obs.counter("ckpt_snapshot_seconds_total").value >= 0
    assert obs.gauge("ckpt_pending").value == 0  # drained by close()


def test_run_steps_cadence_and_drain_on_exit(tmp_path):
    d = str(tmp_path)

    def step_fn(state, batch):
        new = {"step": state["step"] + 1, "w": state["w"] + batch}
        return new, {"loss": float(new["w"][0])}

    eng = ckpt.AsyncCheckpointEngine(d, save_every_n=2)
    state, metrics = run_steps(step_fn, _state(0), [1.0] * 5, engine=eng)
    # saves queued at steps 2 and 4; the drain on exit publishes the newest
    # (step 2's may be superseded if the loop outruns the writer)
    assert eng.saves_accepted == 2
    assert "ckpt_4" in os.listdir(d) and set(os.listdir(d)) <= {"ckpt_2", "ckpt_4"}
    assert metrics["loss"] == 5.0
    restored, path = checkpoint.restore_latest(d)
    assert os.path.basename(path) == "ckpt_4"
    assert torch.equal(restored["w"], torch.full((16,), 4.0))
    eng.close()


def test_run_steps_explicit_cadence_overrides_the_engine(tmp_path):
    d = str(tmp_path)
    with ckpt.AsyncCheckpointEngine(d, save_every_n=1) as eng:
        run_steps(lambda s, b: ({"step": s["step"] + 1, "w": s["w"]}, {}), _state(0), [None] * 4,
                  engine=eng, save_every_n=4)
    assert sorted(os.listdir(d)) == ["ckpt_4"]


def test_run_steps_drains_on_error_exit(tmp_path):
    d = str(tmp_path)

    def step_fn(state, batch):
        if batch == "boom":
            raise ValueError("boom")
        return {"step": state["step"] + 1, "w": state["w"]}, {}

    with ckpt.AsyncCheckpointEngine(d, save_every_n=1) as eng:
        with pytest.raises(ValueError):
            run_steps(step_fn, _state(0), [None, "boom"], engine=eng)
    assert sorted(os.listdir(d)) == ["ckpt_1"]  # the step-1 save landed


def test_run_steps_snapshots_a_train_state_in_place_updated(tmp_path):
    """A TrainState whose step updates its tensors in place: each commit
    holds the state of its own step, not a later one's, and restores into a
    fresh state in place (the same parameter objects)."""
    d = str(tmp_path)
    strategy = SyncDataParallel("cpu")
    optimizer = optim.sgd(0.1, momentum=0.9)
    torch.manual_seed(0)
    state = strategy.create_state(lambda: torch.nn.Linear(3, 2), optimizer)
    step = strategy.compile_train_step(lambda m, b: m(b["x"]).square().mean(), optimizer)
    batch = {"x": torch.ones(4, 3)}
    seen = {}

    def record(s, global_step, metrics):
        seen[global_step] = {k: v.detach().clone() for k, v in s.params.items()}

    with ckpt.AsyncCheckpointEngine(d, save_every_n=1) as eng:
        state, _ = run_steps(step, state, [batch] * 3, engine=eng, hooks=[record])
    for n in (1, 2, 3):
        tree = checkpoint.restore_checkpoint(os.path.join(d, "ckpt_{}".format(n))) \
            if os.path.isdir(os.path.join(d, "ckpt_{}".format(n))) else None
        if tree is not None:  # a superseded snapshot never commits
            assert tree["step"] == n and int(tree["opt_state"]["count"]) == n
            for name, value in seen[n].items():
                assert torch.equal(tree["params"][name], value), (n, name)
    torch.manual_seed(1)
    fresh = strategy.create_state(lambda: torch.nn.Linear(3, 2), optimizer)
    weight = fresh.module.weight
    restored, path = checkpoint.restore_latest(d, target=fresh)
    assert restored is fresh and fresh.module.weight is weight and fresh.step == 3
    assert torch.equal(weight, state.module.weight)
    assert torch.equal(fresh.opt_state["trace"]["weight"], state.opt_state["trace"]["weight"])


def test_drain_on_child_exit_lands_a_pending_commit(tmp_path):
    """The trainer child's exit path drains every live engine, so a
    snapshot accepted just before the user function returned commits."""
    d = str(tmp_path)
    _arm("ckpt.write_slow", probability=1.0, max_count=1, delay_s=0.3)
    eng = ckpt.AsyncCheckpointEngine(d)
    eng.save(_state(5), 5)
    assert ckpt.busy_descriptions()
    TFSparkNode._drain_checkpoints()
    assert not ckpt.busy_descriptions()
    assert ckpt.verify(os.path.join(d, "ckpt_5")) == (True, "verified")
    eng.close()


# -- snapshot buffers ----------------------------------------------------------


@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_snapshot_owns_its_memory(kind):
    src = {"w": torch.arange(8, dtype=torch.float32)}
    if kind == "numpy":
        src = {"w": np.arange(8, dtype=np.float32)}
    snap = snapshot_to_host(src, step=1)
    src["w"][:] = -1.0  # the source updated in place right after
    assert snap.event is None  # nothing on a card: nothing to wait for
    assert torch.equal(snap.tree["w"], torch.arange(8, dtype=torch.float32))


def test_snapshot_of_a_train_state_is_the_saved_layout():
    module = torch.nn.BatchNorm1d(3)
    optimizer = optim.adamw(1e-3)
    state = TrainState(7, module, optimizer.init(dict(module.named_parameters())))
    snap = snapshot_to_host(state, step=7)
    tree = snap.tree
    assert tree["step"] == 7 and tree[checkpoint._STATE_SENTINEL] == 1
    assert set(tree["params"]) == {"weight", "bias"}
    assert set(tree["model_state"]) == {"running_mean", "running_var", "num_batches_tracked"}
    assert set(tree["opt_state"]) == {"count", "mu", "nu"}
    assert tree["params"]["weight"] is not module.weight
    assert snap.nbytes == sum(t.numel() * t.element_size() for t in
                              [*tree["params"].values(), *tree["model_state"].values(),
                               tree["opt_state"]["count"], *tree["opt_state"]["mu"].values(),
                               *tree["opt_state"]["nu"].values()])


def test_snapshot_slot_reuse_after_release():
    pool = SnapshotBuffers(depth=2)
    a = pool.take(_state(1))
    buf_a = a.tree["w"]
    pool.release(a)
    b = pool.take(_state(2))
    assert b.tree["w"] is buf_a  # pooled buffer reused, no realloc
    assert torch.equal(b.tree["w"], torch.full((16,), 2.0))


def test_snapshot_overflow_beyond_depth_is_unpooled():
    pool = SnapshotBuffers(depth=2)
    held = [pool.take(_state(i)) for i in range(3)]
    assert held[0].slot is not None and held[1].slot is not None
    assert held[2].slot is None  # overflow: fresh unpooled buffers
    for snap in held:
        pool.release(snap)


def test_snapshot_shape_change_evicts_stale_slots():
    pool = SnapshotBuffers(depth=1)
    a = pool.take({"w": torch.zeros(4)})
    pool.release(a)
    b = pool.take({"w": torch.zeros(8)})  # new signature
    assert b.slot is not None and b.tree["w"].shape == (8,)
    pool.release(b)


def test_snapshot_stall_is_charged_to_the_snapshot_counter():
    plan = _arm("ckpt.snapshot_stall", probability=1.0, max_count=1, delay_s=0.05)
    before = obs.counter("ckpt_snapshot_seconds_total").value
    snap = snapshot_to_host(_state(1), step=1)
    assert plan.fired("ckpt.snapshot_stall") == 1
    assert torch.equal(snap.tree["w"], torch.full((16,), 1.0))
    assert obs.counter("ckpt_snapshot_seconds_total").value - before >= 0.05


# -- prune guard and staging dirs ---------------------------------------------


def test_prune_spares_an_in_flight_checkpoint(tmp_path):
    d = str(tmp_path)
    _save_steps(d, [1, 2, 3])
    removed = checkpoint.prune_checkpoints(d, keep=1, in_flight={os.path.join(d, "ckpt_1")})
    assert removed == 1  # only ckpt_2: ckpt_1 is mid-commit, ckpt_3 kept
    assert sorted(os.listdir(d)) == ["ckpt_1", "ckpt_3"]


def test_staging_dirs_are_invisible_everywhere(tmp_path):
    d = str(tmp_path)
    _save_steps(d, [2])
    os.makedirs(os.path.join(d, "tmp.ckpt_5"))  # torn commit leftover
    assert checkpoint.latest_checkpoint(d).endswith("ckpt_2")
    assert checkpoint.latest_checkpoint(d, prefix="").endswith("ckpt_2")
    assert checkpoint.prune_checkpoints(d, keep=1) == 0
    assert os.path.isdir(os.path.join(d, "tmp.ckpt_5"))


def test_engine_registry_feeds_the_default_guard(tmp_path):
    eng = ckpt.AsyncCheckpointEngine(str(tmp_path))
    try:
        assert eng.busy_paths() == set() and ckpt.in_flight_paths() == set()
        eng.save(_state(1), 1)
        eng.drain(timeout=60)
        assert ckpt.in_flight_paths() == set()
    finally:
        eng.close()


# -- chaos: commits torn, bitrot, supersede, restores that fail --------------------


@pytest.mark.parametrize("save", ["sync", "async"])
def test_bitrot_after_the_manifest_is_skipped_with_a_reason(tmp_path, caplog, save):
    model_dir = str(tmp_path)
    write = _save_steps if save == "sync" else _save_async
    write(model_dir, [1])
    _arm("checkpoint.corrupt_write", probability=1.0, max_count=1)
    write(model_dir, [2])
    chaos.uninstall()
    ok, reason = ckpt.verify(os.path.join(model_dir, "ckpt_2"))
    assert not ok and ("mismatch" in reason or "torn" in reason or "missing" in reason)
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        state, path = checkpoint.restore_latest(model_dir)
    assert os.path.basename(path) == "ckpt_1" and state["step"] == 1
    joined = " ".join(r.getMessage() for r in caplog.records)
    assert "skipping checkpoint" in joined and "ckpt_2" in joined


def test_commit_tear_leaves_staging_unpublished_then_a_retry_sweeps_it(tmp_path):
    model_dir = str(tmp_path)
    _save_async(model_dir, [1])
    _arm("ckpt.commit_tear", probability=1.0, max_count=1)
    _save_async(model_dir, [2])
    chaos.uninstall()
    assert os.path.isdir(os.path.join(model_dir, "tmp.ckpt_2"))
    assert not os.path.isdir(os.path.join(model_dir, "ckpt_2"))
    _, path = checkpoint.restore_latest(model_dir)
    assert os.path.basename(path) == "ckpt_1"
    _save_async(model_dir, [2])
    assert not os.path.isdir(os.path.join(model_dir, "tmp.ckpt_2"))
    state, path = checkpoint.restore_latest(model_dir)
    assert os.path.basename(path) == "ckpt_2" and torch.equal(state["w"], torch.full((16,), 2.0))


def test_publish_torn_manifest_is_skipped_with_a_reason(tmp_path, caplog):
    model_dir = str(tmp_path)
    _save_async(model_dir, [1])
    _arm("ckpt.commit_tear", probability=1.0, max_count=1, publish_torn=True)
    _save_async(model_dir, [2])
    chaos.uninstall()
    assert os.path.isdir(os.path.join(model_dir, "ckpt_2"))
    ok, reason = ckpt.verify(os.path.join(model_dir, "ckpt_2"))
    assert not ok and "torn manifest" in reason
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        _, path = checkpoint.restore_latest(model_dir)
    assert os.path.basename(path) == "ckpt_1"
    joined = " ".join(r.getMessage() for r in caplog.records)
    assert "torn manifest" in joined and "after skipping 1 newer checkpoint" in joined


def test_newer_snapshot_supersedes_a_queued_one(tmp_path):
    model_dir = str(tmp_path)
    before = obs.counter("ckpt_superseded_total").value
    plan = _arm("ckpt.write_slow", probability=1.0, max_count=1, delay_s=0.5)
    with ckpt.AsyncCheckpointEngine(model_dir) as eng:
        eng.save(_state(1), 1)
        deadline = time.monotonic() + 30
        while not plan.fired("ckpt.write_slow") and time.monotonic() < deadline:
            time.sleep(0.005)
        assert plan.fired("ckpt.write_slow") == 1  # the writer sits in its stall
        eng.save(_state(2), 2)
        held = eng._pending.slot
        eng.save(_state(3), 3)
        # step 2's buffers were released before step 3's snapshot was taken,
        # so it reuses them: two buffer sets busy, never a third
        assert held is not None and eng._pending.slot is held
        assert eng.drain(timeout=60)
    assert sorted(os.listdir(model_dir)) == ["ckpt_1", "ckpt_3"]
    assert obs.counter("ckpt_superseded_total").value == before + 1
    _, path = checkpoint.restore_latest(model_dir)
    assert os.path.basename(path) == "ckpt_3"


def test_training_continues_while_a_write_is_in_flight(tmp_path):
    model_dir = str(tmp_path)
    delay_s = 1.0
    _arm("ckpt.write_slow", probability=1.0, max_count=1, delay_s=delay_s)
    with ckpt.AsyncCheckpointEngine(model_dir) as eng:
        state = _state(0)
        eng.save(state, 1)
        t0 = time.monotonic()
        for _ in range(20):
            state = {"step": state["step"] + 1, "w": state["w"] + 1.0}
        stepped = time.monotonic() - t0
        assert eng.drain(timeout=0.05) is False  # still in flight
        assert stepped < delay_s / 2
        assert eng.drain(timeout=60) and eng.error is None
    assert ckpt.verify(os.path.join(model_dir, "ckpt_1")) == (True, "verified")


def test_corrupt_newest_falls_back_to_the_previous(tmp_path):
    model_dir = str(tmp_path)
    _save_steps(model_dir, [1, 2])
    _arm("checkpoint.corrupt_write", probability=1.0, max_count=1)
    _save_steps(model_dir, [3])
    chaos.uninstall()
    state, path = checkpoint.restore_latest(model_dir)
    assert os.path.basename(path) == "ckpt_2" and state["step"] == 2


def test_restore_fail_once_falls_back_then_heals(tmp_path):
    model_dir = str(tmp_path)
    _save_steps(model_dir, [1, 2])
    plan = _arm("checkpoint.restore_fail", probability=1.0, max_count=1)
    state, path = checkpoint.restore_latest(model_dir)
    assert plan.fired("checkpoint.restore_fail") == 1
    assert os.path.basename(path) == "ckpt_1" and state["step"] == 1
    state, path = checkpoint.restore_latest(model_dir)  # the budget is spent
    assert os.path.basename(path) == "ckpt_2"


def test_every_checkpoint_failing_raises(tmp_path):
    model_dir = str(tmp_path)
    _save_steps(model_dir, [1])
    _arm("checkpoint.restore_fail", probability=1.0)
    with pytest.raises(IOError):
        checkpoint.restore_latest(model_dir)


def test_empty_dir_is_a_clean_fresh_start(tmp_path):
    assert checkpoint.restore_latest(str(tmp_path)) == (None, None)
    assert checkpoint.restore_latest(str(tmp_path / "absent")) == (None, None)


def test_a_checkpoint_that_does_not_fit_the_state_raises_before_copying(tmp_path):
    """Targeted restore into a live TrainState: a checkpoint of another
    shape is skipped with its reason, and the state is left untouched."""
    model_dir = str(tmp_path)
    small_module = torch.nn.Linear(2, 2)
    small = TrainState(4, small_module, optim.sgd(0.1, momentum=0.9).init(dict(small_module.named_parameters())))
    checkpoint.save_checkpoint(os.path.join(model_dir, "ckpt_4"), small)
    big = torch.nn.Linear(3, 2)
    target = TrainState(0, big, optim.sgd(0.1, momentum=0.9).init(dict(big.named_parameters())))
    weight = big.weight.detach().clone()
    with pytest.raises(ValueError, match="checkpoint"):
        checkpoint.restore_latest(model_dir, target=target)
    assert torch.equal(big.weight, weight) and target.step == 0


def test_restore_latest_into_a_train_state_skips_a_corrupt_newest(tmp_path):
    """The targeted restore the examples use, through the fallback path."""
    model_dir = str(tmp_path)
    strategy = SyncDataParallel("cpu")
    optimizer = optim.sgd(0.1, momentum=0.9)
    torch.manual_seed(0)
    state = strategy.create_state(lambda: torch.nn.Linear(3, 2), optimizer)
    state.step = 5
    checkpoint.save_checkpoint(os.path.join(model_dir, "ckpt_5"), state)
    _arm("checkpoint.corrupt_write", probability=1.0)
    checkpoint.save_checkpoint(os.path.join(model_dir, "ckpt_9"), state)
    chaos.uninstall()
    torch.manual_seed(1)
    fresh = strategy.create_state(lambda: torch.nn.Linear(3, 2), optimizer)
    restored, path = checkpoint.restore_latest(model_dir, target=fresh)
    assert os.path.basename(path) == "ckpt_5" and restored.step == 5
    assert torch.equal(fresh.module.weight, state.module.weight)


# -- prefix warnings -------------------------------------------------------------


def test_warns_when_numbered_dirs_miss_the_prefix(tmp_path, caplog):
    os.makedirs(str(tmp_path / "model_3"))
    os.makedirs(str(tmp_path / "model_7"))
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        assert checkpoint.latest_checkpoint(str(tmp_path)) is None
        assert checkpoint.restore_latest(str(tmp_path)) == (None, None)
    joined = " ".join(r.getMessage() for r in caplog.records)
    assert "none match" in joined and 'prefix=""' in joined and "model_7" in joined


def test_no_prefix_warning_for_empty_or_matching_dirs(tmp_path, caplog):
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        assert checkpoint.latest_checkpoint(str(tmp_path)) is None
        os.makedirs(str(tmp_path / "ckpt_4"))
        assert checkpoint.latest_checkpoint(str(tmp_path)).endswith("ckpt_4")
    assert not caplog.records


def test_prefix_escape_hatch_accepts_any_layout(tmp_path):
    os.makedirs(str(tmp_path / "model_3"))
    assert checkpoint.latest_checkpoint(str(tmp_path), prefix="").endswith("model_3")


def test_export_saved_model_writes_a_restorable_checkpoint(tmp_path):
    from tensorflowonspark_tpu_torch import TFNode

    module = torch.nn.Linear(2, 2)
    state = TrainState(3, module, optim.sgd(0.1).init(dict(module.named_parameters())))
    path = TFNode.export_saved_model(str(tmp_path / "model"), str(tmp_path / "export"), state)
    assert ckpt.verify(path) == (True, "verified")
    tree = checkpoint.restore_checkpoint(path)
    assert tree["step"] == 3 and torch.equal(tree["params"]["weight"], module.weight.detach())


# -- cluster leg: a commit torn inside a trainer child ---------------------------


def _seed_firing_on_nth(site, n, probability):
    """A plan seed whose RNG for ``site`` stays quiet for the first ``n - 1``
    arrivals and fires on the n-th (the stream ChaosPlan rolls)."""
    for seed in range(10000):
        rng = random.Random("{}:{}".format(seed, site))
        draws = [rng.random() for _ in range(n)]
        if all(d >= probability for d in draws[:-1]) and draws[-1] < probability:
            return seed
    raise AssertionError("no seed fires {} on arrival {}".format(site, n))


def fn_train_with_async_ckpt(args, ctx):
    """In the trainer child: two async saves under the propagated plan (the
    second commit tears), then it serves the feed so the metrics publisher
    ships the child's counters to the driver."""
    import torch as _torch

    from tensorflowonspark_tpu_torch import chaos as _chaos
    from tensorflowonspark_tpu_torch import ckpt as _ckpt

    assert _chaos.active, "chaos plan did not reach the trainer child"
    with _ckpt.AsyncCheckpointEngine(args["model_dir"]) as eng:
        for step in (1, 2):
            eng.save({"step": step, "w": _torch.full((8,), float(step))}, step)
            assert eng.drain(timeout=120)
    feed = ctx.get_data_feed(train_mode=False)
    while not feed.should_stop():
        batch = feed.next_batch(16)
        if batch:
            feed.batch_results([x + 1 for x in batch])


def test_tear_in_a_trainer_child_surfaces_in_metrics_and_restore_prefers_good(tmp_path):
    from tensorflowonspark_tpu_torch import TFCluster
    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext

    model_dir = str(tmp_path / "model")
    seed = _seed_firing_on_nth("ckpt.commit_tear", 2, 0.5)
    chaos.install(chaos.ChaosPlan(seed=seed).site("ckpt.commit_tear", probability=0.5, max_count=1))
    sc = LocalSparkContext(num_executors=1, task_timeout=120)
    try:
        cluster = TFCluster.run(
            sc, fn_train_with_async_ckpt, {"model_dir": model_dir}, 1,
            input_mode=TFCluster.InputMode.SPARK, master_node=None, env=CPU_ENV,
            jax_distributed=False, reservation_timeout=180,
        )
        try:
            results = cluster.inference(sc.parallelize(range(20), 2)).collect()
            assert sorted(results) == list(range(1, 21))
            deadline = time.monotonic() + 60
            while True:
                counters = cluster.metrics()["counters"]
                tears = counters.get("chaos_fault_ckpt_commit_tear_total", {}).get("value", 0)
                if tears >= 1 or time.monotonic() > deadline:
                    break
                time.sleep(0.5)
            assert counters["chaos_fault_ckpt_commit_tear_total"]["value"] >= 1
            assert counters["ckpt_commits_total"]["value"] >= 1
            assert counters["ckpt_bytes_total"]["value"] > 0
        finally:
            cluster.shutdown(timeout=120)
    finally:
        sc.stop()
        chaos.uninstall()
    assert os.path.isdir(os.path.join(model_dir, "tmp.ckpt_2"))
    state, path = checkpoint.restore_latest(model_dir)
    assert os.path.basename(path) == "ckpt_1" and state["step"] == 1
