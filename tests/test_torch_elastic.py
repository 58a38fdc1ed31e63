"""The recovery ladder on the port: the JAX package's ``tests/test_elastic.py``.

Its unit cases (classification, the ledger, blacklist-aware templates,
reservation attribution and refusal, the preflight gate, the final
failure) run on :mod:`tensorflowonspark_tpu_torch.elastic` with only the
package name rewritten and their assertions unchanged. Its two end-to-end
stories run with ``map_fun`` functions on torch in a **2-executor gloo world**
(``jax_distributed=True``): the MLP trains on ``ctx.mesh({"dp": 1, "fsdp":
-1})`` under ZeRO-3 (``fsdp`` = 2 at full size, 1 after the shrink), every
rank on its block of the same 16 rows a step, saving through the async
engine (a collective save: the gathers on every rank, rank 0 writes). The
ranks of a world cannot finish apart, so a full-size life trains to
``hold`` and then keeps the world busy with an all-reduce a beat until the
kill: the survivor's collective then fails on the lost peer, and the ladder
must still blame the victim, whose exit reaches the driver first. Each story keeps the reference's assertions
(relaunches, blacklist, sizes, ``final_step``, ``resumed_from``, the
counters) at the world's sizes, and adds two: the final checkpoint equals,
bitwise, an uninterrupted port run from the checkpoint the last life
restored, and the trajectory lies within 1e-5 of the JAX package's
``SyncDataParallel`` taking the same steps on the same rows from the same
weights (``test_torch_resume.py``'s limit).
"""

import json
import os
import socket
import time

import jax
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_tpu import parallel as jax_parallel
from tensorflowonspark_tpu.models import mnist as jmnist
from tensorflowonspark_tpu.train import SyncDataParallel as JaxSyncDataParallel
from tensorflowonspark_tpu_torch import TFCluster, chaos, control, convert, elastic, reservation, util
from tensorflowonspark_tpu_torch.TFCluster import InputMode
from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
from tensorflowonspark_tpu_torch.models import mnist
from tensorflowonspark_tpu_torch.parallel.mesh import mesh_shape
from tensorflowonspark_tpu_torch.reservation import MessageSocket
from tensorflowonspark_tpu_torch.train import SyncDataParallel, checkpoint, optim

CPU_ENV = {util.ENV_PLATFORM: "cpu"}
TOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.uninstall()
    yield
    chaos.uninstall()


# -- classification ------------------------------------------------------------


class TestClassifyFailure:
    def test_reservation_timeout_carries_missing_ids(self):
        err = reservation.ReservationError("timed out", missing=[2, 3])
        wrapper = RuntimeError("cluster attempt failed")
        wrapper.__cause__ = err
        event = elastic.classify_failure(wrapper)
        assert event.kind == "reservation_timeout"
        assert event.executor_ids == [2, 3]

    def test_heartbeat_loss_attributed_via_role_map(self):
        exc = RuntimeError(
            "cluster failed: node worker:1 stopped heartbeating for 31s "
            "without a final status (child killed?)"
        )
        event = elastic.classify_failure(exc, role_map={"worker:1": 4})
        assert event.kind == "heartbeat_loss"
        assert event.executor_ids == [4]

    def test_signal_exit_is_node_exit(self):
        exc = RuntimeError("node worker:0 failed (exit -9):\n<no output>")
        event = elastic.classify_failure(exc, role_map={"worker:0": 0})
        assert event.kind == "node_exit"
        assert event.executor_ids == [0]

    def test_user_error_exit_is_node_error_not_loss(self):
        exc = RuntimeError("node worker:0 failed (exit 1):\nTraceback ...")
        event = elastic.classify_failure(exc, role_map={"worker:0": 0})
        assert event.kind == "node_error"
        assert event.kind not in elastic.LOSS_KINDS

    def test_lease_expired_attributed_via_executor_tag(self):
        # the registry watchdog names the executor inline, so
        # attribution no longer depends on a role_map being threaded through
        exc = RuntimeError(
            "cluster failed: node worker:1 stopped heartbeating: lease "
            "expired after 31s without renewal (executor 4)"
        )
        event = elastic.classify_failure(exc)
        assert event.kind == "lease_expired"
        assert event.executor_ids == [4]
        assert event.kind in elastic.LOSS_KINDS

    def test_lease_expired_counts_toward_suspects(self):
        ledger = elastic.FailureLedger(max_restarts=8, blacklist_after=2)
        event = elastic.FailureEvent("lease_expired", [3], "lease expired (executor 3)")
        ledger.record(event)
        assert ledger.suspects() == []
        ledger.record(event)
        assert ledger.suspects() == [3]

    def test_feed_timeout(self):
        exc = RuntimeError("feed timeout: queue 'input' still has 3 unconsumed items")
        assert elastic.classify_failure(exc).kind == "feed_timeout"

    def test_preempted_is_first_class_and_budget_exempt(self):
        # the child's SIGTERM drain commits a ``preempted`` parting status;
        # the watchdog stamps it into the failure text with the executor id
        exc = RuntimeError("cluster failed: node worker:1 preempted (executor 3)")
        event = elastic.classify_failure(exc)
        assert event.kind == "preemption"
        assert event.executor_ids == [3]
        assert event.kind not in elastic.LOSS_KINDS
        assert event.kind in elastic.BUDGET_EXEMPT_KINDS

    def test_preemption_wins_over_late_expiry_phrasing(self):
        # a drained child's exit can race a late watchdog expiry into the
        # same failure text: the warned signal must win the classification
        exc = RuntimeError(
            "node worker:1 preempted (executor 3)\nnode worker:1 stopped "
            "heartbeating: lease expired after 31s without renewal (executor 3)"
        )
        assert elastic.classify_failure(exc).kind == "preemption"

    def test_unclassifiable_is_unknown(self):
        event = elastic.classify_failure(ValueError("something odd"))
        assert event.kind == "unknown"
        assert event.executor_ids == []


# -- ledger --------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class TestFailureLedger:
    def test_restart_budget_is_window_scoped(self):
        clock = FakeClock()
        ledger = elastic.FailureLedger(max_restarts=2, window_secs=600, clock=clock)
        ledger.record(elastic.FailureEvent("unknown"))
        ledger.record(elastic.FailureEvent("unknown"))
        assert ledger.allow_restart()
        ledger.record(elastic.FailureEvent("unknown"))
        assert not ledger.allow_restart()  # 3 failures inside the window
        clock.t += 601  # the window slides past all three
        assert ledger.allow_restart()
        assert ledger.failures_in_window() == 0

    def test_suspects_need_repeated_loss_kind_failures(self):
        ledger = elastic.FailureLedger(blacklist_after=2)
        ledger.record(elastic.FailureEvent("node_exit", [1]))
        assert ledger.suspects() == []  # one transient loss never blacklists
        ledger.record(elastic.FailureEvent("feed_timeout", [1]))
        assert ledger.suspects() == []  # non-loss kinds never count
        ledger.record(elastic.FailureEvent("heartbeat_loss", [1]))
        assert ledger.suspects() == [1]

    def test_clear_forgives_one_executor(self):
        ledger = elastic.FailureLedger(blacklist_after=1)
        ledger.record(elastic.FailureEvent("node_exit", [1]))
        ledger.record(elastic.FailureEvent("node_exit", [2]))
        assert ledger.suspects() == [1, 2]
        ledger.clear(1)
        assert ledger.suspects() == [2]

    def test_preemption_never_consumes_the_restart_budget(self):
        # SIGTERM-then-clean-exit is *warned* downsizing: any number of
        # drained preemptions must leave the whole budget for real failures
        ledger = elastic.FailureLedger(max_restarts=1, blacklist_after=1)
        for _ in range(5):
            ledger.record(elastic.FailureEvent("preemption", [1], "preempted"))
        assert ledger.failures_in_window() == 0
        assert ledger.allow_restart()
        ledger.record(elastic.FailureEvent("node_exit", [2]))
        assert ledger.failures_in_window() == 1
        assert ledger.allow_restart()  # 1 real failure <= max_restarts=1
        ledger.record(elastic.FailureEvent("node_exit", [2]))
        assert not ledger.allow_restart()

    def test_preemption_never_counts_toward_blacklist(self):
        # a preempted-then-returning executor must rejoin without a ledger
        # entry: no suspects, so the next plan stays at full size and the
        # executor is back in the template
        ledger = elastic.FailureLedger(blacklist_after=1)
        ledger.record(elastic.FailureEvent("preemption", [1], "preempted"))
        ledger.record(elastic.FailureEvent("preemption", [1], "preempted"))
        assert ledger.suspects() == []
        assert elastic.plan_size(2, set(ledger.suspects())) == 2
        template = TFCluster.build_cluster_template(
            2, master_node=None, blacklist=set(ledger.suspects())
        )
        assert 1 in template

    def test_preemptions_still_appear_in_events(self):
        # exempt from the budget, not from the record: the trace/result
        # timeline still shows every drained preemption
        ledger = elastic.FailureLedger(max_restarts=0)
        ledger.record(elastic.FailureEvent("preemption", [1], "preempted"))
        assert [e.kind for _, e in ledger.events()] == ["preemption"]

    def test_shrink_never_goes_below_min_workers(self):
        assert elastic.plan_size(4, {3}, min_workers=2) == 3
        assert elastic.plan_size(4, {1, 3}, min_workers=2) == 2
        with pytest.raises(RuntimeError, match="min_workers"):
            elastic.plan_size(4, {1, 2, 3}, min_workers=2)
        # overhead (ps/evaluator) doesn't count toward the worker floor
        with pytest.raises(RuntimeError, match="min_workers"):
            elastic.plan_size(4, {3}, min_workers=3, overhead=1)


# -- blacklist threading -------------------------------------------------------


class TestBlacklistTemplate:
    def test_roles_skip_blacklisted_executors(self):
        template = TFCluster.build_cluster_template(
            3, master_node="chief", blacklist={1}
        )
        assert template == {0: ("chief", 0), 2: ("worker", 0), 3: ("worker", 1)}

    def test_empty_blacklist_is_identical_to_no_blacklist(self):
        assert TFCluster.build_cluster_template(4, num_ps=1) == (
            TFCluster.build_cluster_template(4, num_ps=1, blacklist=set())
        )


def _send_reg(addr, executor_id):
    """One raw REG exchange (no Client: its retry policy would turn the
    deliberate ERROR reply into seconds of backoff)."""
    with socket.create_connection(addr, timeout=10) as sock:
        msock = MessageSocket(sock)
        msock.send({"type": "REG", "data": {"executor_id": executor_id}})
        return msock.recv()


class TestReservationAttribution:
    def test_timeout_lists_never_registered_executors(self):
        server = reservation.Server(2, expected_ids=[0, 1])
        addr = server.start()
        try:
            assert _send_reg(("127.0.0.1", addr[1]), 0)["type"] == "OK"
            with pytest.raises(reservation.ReservationError) as excinfo:
                server.await_reservations(timeout=1.0, poll_interval=0.1)
            assert "never registered: executors [1]" in str(excinfo.value)
            assert excinfo.value.missing == [1]
        finally:
            server.stop()

    def test_blacklisted_registration_is_refused(self):
        server = reservation.Server(1, expected_ids=[0], blacklist={1})
        addr = server.start()
        try:
            reply = _send_reg(("127.0.0.1", addr[1]), 1)
            assert reply["type"] == "ERROR"
            assert "blacklisted" in reply["data"]
            assert server.reservations.remaining() == 1  # nothing stored
            # a healthy executor still registers
            assert _send_reg(("127.0.0.1", addr[1]), 0)["type"] == "OK"
        finally:
            server.stop()


# -- preflight gate ------------------------------------------------------------


def _probe_fail_on_1(executor_id):
    if executor_id == 1:
        raise IOError("scratch disk full")


class TestPreflight:
    def test_healthy_executors_pass(self):
        sc = LocalSparkContext(num_executors=2, task_timeout=120)
        try:
            assert elastic.preflight_executors(sc, [0, 1]) == {}
        finally:
            sc.stop()

    def test_extra_probe_failure_is_attributed(self):
        sc = LocalSparkContext(num_executors=2, task_timeout=120)
        try:
            bad = elastic.preflight_executors(sc, [0, 1], extra_probe=_probe_fail_on_1)
            assert list(bad) == [1]
            assert "disk full" in bad[1]
        finally:
            sc.stop()

    def test_unpinnable_backend_reports_nothing(self):
        class NoPin:
            pass

        assert elastic.preflight_executors(NoPin(), [0]) == {}


# -- final-failure path --------------------------------------------------------


def fn_always_dies(args, ctx):
    raise RuntimeError("synthetic training failure")


def test_final_failure_aborts_and_chains_cause(tmp_path, monkeypatch):
    """When the window budget is spent the ladder must (a) have aborted every
    failed attempt — the caller gets their executors back — and (b) raise a
    RuntimeError chaining the last underlying failure."""
    aborts = []
    real_abort = TFCluster.TFCluster.abort

    def spying_abort(self, reason="aborted by driver", wait_secs=60):
        aborts.append(str(reason))
        return real_abort(self, reason, wait_secs)

    monkeypatch.setattr(TFCluster.TFCluster, "abort", spying_abort)
    sc = LocalSparkContext(num_executors=1, task_timeout=300)
    try:
        with pytest.raises(RuntimeError, match="failed after 1 relaunch") as excinfo:
            TFCluster.run_with_recovery(
                sc, fn_always_dies, {}, num_executors=1,
                input_mode=InputMode.TENSORFLOW, master_node=None,
                env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
                max_relaunches=1, shutdown_timeout=120, preflight=False,
            )
        assert excinfo.value.__cause__ is not None
        assert "synthetic training failure" in str(excinfo.value.__cause__)
    finally:
        sc.stop()
    assert len(aborts) == 2  # both failed attempts were torn down


# -- end to end, in a gloo world: the MLP under ZeRO-3 -------------------------

MLP = dict(hidden=8, dropout_rate=0.0)


def _rows():
    rng = np.random.default_rng(7)
    return {"image": rng.standard_normal((16, 28, 28)).astype(np.float32),
            "label": rng.integers(0, 10, 16)}


def _jax_variables():
    """The JAX package's initial MLP weights (PRNGKey(0)), on the host: both
    sides start from them."""
    variables = jmnist.make_init_fn(jmnist.create_model("mlp", **MLP))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jax.device_get(variables))


def _mlp_world(args, ctx):
    """(strategy, state, step, batch) of the MLP on ``{"dp": 1, "fsdp":
    -1}`` over the current world, ZeRO-3 on every array
    (``min_weight_size=1``), SGD 0.1, from the JAX package's initial
    weights; the batch is this rank's block of the 16 rows."""
    from tensorflowonspark_tpu_torch.models import mnist
    from tensorflowonspark_tpu_torch.parallel import sharding
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim

    strategy = SyncDataParallel(ctx.mesh({"dp": 1, "fsdp": -1}), fsdp=True, min_weight_size=1)
    optimizer = optim.sgd(0.1)
    model = convert.load_variables(mnist.create_model("mlp", **MLP), args["variables"])
    state = strategy.create_state(lambda: model, optimizer)
    step = strategy.compile_train_step(mnist.make_loss_fn(model), optimizer, has_aux=True)
    share, shares = sharding.data_shard(strategy.mesh, ctx.process_id)
    n = 16 // shares
    batch = strategy.shard_batch({k: v[share * n:(share + 1) * n] for k, v in _rows().items()})
    return strategy, state, step, batch


def _resume(args, strategy, state):
    from tensorflowonspark_tpu_torch.ckpt.reshard import reshard_restore

    latest = checkpoint.latest_checkpoint(args["model_dir"])
    if latest:
        state = reshard_restore(latest, strategy=strategy, target=state)
    return state, state.step


def _hold_world(args):
    """Keep the world busy until the kill: an all-reduce a beat (a rank's
    loss fails the survivor's next one)."""
    import torch.distributed as dist

    while True:
        dist.all_reduce(torch.zeros(1))
        time.sleep(args["step_pace_secs"])


def fn_elastic_train(args, ctx):
    """The shrink story's workload. At full size every life trains to
    ``hold`` and then holds the world until the chaos kill (victim-scoped,
    not latched: the victim dies on every life); the shrunk life (one rank)
    reshard-restores the newest checkpoint and trains to ``target_steps``.
    Only the world's rank 0 writes (the save's gathers run on every rank)."""
    from tensorflowonspark_tpu_torch import ckpt

    num_workers = ctx.num_workers
    strategy, state, step, batch = _mlp_world(args, ctx)
    state, resumed_from = _resume(args, strategy, state)
    global_step = state.step
    stop = args["target_steps"] if num_workers == 1 else args["hold"]
    with ckpt.AsyncCheckpointEngine(args["model_dir"]) as eng:
        while global_step < stop:
            state, metrics = step(state, batch)
            float(metrics["loss"])
            global_step += 1
            time.sleep(args["step_pace_secs"])
            if global_step % 2 == 0:
                eng.save(state, global_step)
        assert eng.drain(timeout=120)
    if num_workers > 1:
        _hold_world(args)
    with open(os.path.join(args["model_dir"], "done.json"), "w") as f:
        json.dump({"final_step": global_step, "resumed_from": resumed_from, "num_workers": num_workers,
                   "mesh": mesh_shape(strategy.mesh)}, f)


def _port_run_from(path, steps):
    """An uninterrupted port run: the checkpoint at ``path`` restored into a
    fresh MLP state on the CPU, then ``steps`` steps on the same rows (the
    last life ran on one rank: ZeRO-3 at world 1 holds whole tensors)."""
    strategy = SyncDataParallel("cpu")
    optimizer = optim.sgd(0.1)
    model = convert.load_variables(mnist.create_model("mlp", **MLP), _jax_variables())
    state = strategy.create_state(lambda: model, optimizer)
    checkpoint.restore_checkpoint(path, target=state)
    step = strategy.compile_train_step(mnist.make_loss_fn(model), optimizer, has_aux=True)
    batch = strategy.shard_batch(_rows())
    # the threads the last life's one trainer took (the sums' blocking
    # follows the thread count)
    threads = torch.get_num_threads()
    torch.set_num_threads(util.cpu_share(1))
    try:
        for _ in range(steps):
            state, _ = step(state, batch)
    finally:
        torch.set_num_threads(threads)
    return state


def _jax_params(steps):
    """The JAX package's ``SyncDataParallel`` (one CPU device) after
    ``steps`` SGD steps on the same rows from the same weights."""
    jmodel = jmnist.create_model("mlp", **MLP)
    variables = _jax_variables()
    jstrategy = JaxSyncDataParallel(jax_parallel.build_mesh({"dp": 1}, devices=jax.devices()[:1]))
    tx = optax.sgd(0.1)
    jstate = jstrategy.create_state(lambda: variables, tx)
    jstep = jstrategy.compile_train_step(jmnist.make_loss_fn(jmodel), tx, has_aux=True, donate=False)
    batch = jstrategy.shard_batch(_rows())
    for _ in range(steps):
        jstate, _ = jstep(jstate, batch)
    return jax.tree.map(np.asarray, jax.device_get(jstate.params))


def _assert_final_state(model_dir, done):
    """The final checkpoint: bitwise an uninterrupted port run from the
    checkpoint the last life restored, and within TOL of the JAX package."""
    final = checkpoint.restore_checkpoint(os.path.join(model_dir, "ckpt_{}".format(done["final_step"])))
    assert final["step"] == done["final_step"]
    straight = _port_run_from(os.path.join(model_dir, "ckpt_{}".format(done["resumed_from"])),
                              done["final_step"] - done["resumed_from"])
    assert straight.step == done["final_step"]
    for name, value in straight.params.items():
        assert torch.equal(final["params"][name], value.detach()), name
    want = convert.convert_variables({"params": _jax_params(done["final_step"])}, straight.module)
    gap = max(float((final["params"][n] - want[n]).abs().max()) for n in want)
    assert gap <= TOL, gap


@pytest.mark.chaos
def test_node_kill_blacklist_shrink_resharded_resume(tmp_path, monkeypatch):
    """The elasticity acceptance story in a gloo world of 2: chaos SIGKILLs
    executor 1 on every full-size life (fresh per-process plan budget), its
    peer's collective fails on the lost peer, the ledger attributes
    two losses to executor 1 and blacklists it, the third attempt launches
    at N−1 on the 1-rank mesh, reshard-restores the 2-rank ZeRO-3
    checkpoint, and finishes — with the ladder's counters in the metrics
    snapshot captured from ``cluster.metrics()``."""
    monkeypatch.setenv("TOS_MONITOR_INTERVAL", "1")
    monkeypatch.setenv("TOS_HEARTBEAT_INTERVAL", "0.2")
    chaos_log = str(tmp_path / "chaos.log")
    monkeypatch.setenv(chaos.LOG_ENV_VAR, chaos_log)
    model_dir = str(tmp_path / "model")
    os.makedirs(model_dir)
    args = {
        "model_dir": model_dir,
        "target_steps": 12,
        "hold": 8,
        "step_pace_secs": 0.05,
        "victim": 1,
        "variables": _jax_variables(),
    }

    # victim-scoped: only executor 1's trainer dies, 25 beats (~5 s) into
    # its life — after the world has committed its mid-training checkpoints
    # and holds at ``hold``. Every relaunch spawns a fresh child whose plan
    # budget resets, so the victim dies on EVERY full-size life until the
    # ladder stops scheduling it.
    plan = chaos.ChaosPlan(seed=11).site(
        "node.kill", probability=1.0, max_count=1, victim=1, after_beats=25
    )
    chaos.install(plan)
    sc = LocalSparkContext(num_executors=2, task_timeout=900)
    try:
        result = elastic.run_ladder(
            sc, fn_elastic_train, args, num_executors=2,
            max_relaunches=3, min_workers=1, blacklist_after=2,
            input_mode=InputMode.TENSORFLOW, master_node=None,
            env=CPU_ENV, jax_distributed=True, reservation_timeout=180,
            shutdown_timeout=240,
        )
    finally:
        sc.stop()
        chaos.uninstall()

    # the ladder's trajectory: two full-size failures, then shrink to 1
    assert result.relaunches == 2
    assert result.blacklist == {1}
    assert result.num_executors == 1
    # both failures were the victim's loss, never its peer's collective
    assert [(e.kind, e.executor_ids) for _, e in result.events] == [("node_exit", [1])] * 2

    # the kills really came from the chaos site, once per victim life
    with open(chaos_log) as f:
        kills = [line for line in f if line.strip() == "node.kill"]
    assert len(kills) >= 2

    # training completed on the SHRUNK mesh, resuming (not restarting):
    # the final life restored a checkpoint saved on the 2-rank mesh onto 1
    with open(os.path.join(model_dir, "done.json")) as f:
        done = json.load(f)
    assert done["final_step"] == args["target_steps"]
    assert done["num_workers"] == 1
    assert done["mesh"] == {"dp": 1, "fsdp": 1}
    assert done["resumed_from"] >= 1, "final life must resume from a checkpoint"
    _assert_final_state(model_dir, done)

    # the recovery counters are in the merged cluster metrics snapshot
    snap = result.metrics
    assert snap is not None
    assert snap["counters"]["recovery_attempts_total"]["value"] >= 2
    assert snap["counters"]["recovery_shrinks_total"]["value"] >= 1
    assert snap["gauges"]["executors_blacklisted"]["value"] >= 1
    assert snap["counters"]["recovery_seconds_total"]["value"] > 0


def fn_regrow_train(args, ctx):
    """The bidirectional-elasticity workload in a world. Life 1 (full
    size): the world trains to ``hold`` and holds it until the once-latched
    kill of the victim. Life 2 (shrunk to 1): reshard-restores and trains
    *without a stop condition* — only the driver's regrow preemption
    warning ends it, and its drain lands the engine's pending save. Life 3
    (regrown): both ranks reshard-restore the drained checkpoint onto the
    2-rank mesh; the stop condition (full size AND ``target_steps``) is
    satisfiable again; rank 0 saves the final state and records the
    outcome."""
    from tensorflowonspark_tpu_torch import ckpt

    num_workers = ctx.num_workers
    strategy, state, step, batch = _mlp_world(args, ctx)
    state, resumed_from = _resume(args, strategy, state)
    global_step = state.step
    first_life = not os.path.exists(args["latch"])

    with ckpt.AsyncCheckpointEngine(args["model_dir"]) as eng:
        # the stop condition requires the FULL-size mesh: a shrunk life can
        # only end by the driver's preemption warning, whose drain commits
        # the engine's pending save before the exit
        while not (num_workers == args["full_size"] and global_step >= args["target_steps"]):
            if first_life and global_step >= args["hold"]:
                break
            state, metrics = step(state, batch)
            float(metrics["loss"])
            global_step += 1
            time.sleep(args["step_pace_secs"])
            if global_step % 2 == 0:
                eng.save(state, global_step)
        assert eng.drain(timeout=120)
        if first_life:
            _hold_world(args)  # until the latched kill of the victim
        if global_step % 2:
            eng.save(state, global_step)  # the final state
            assert eng.drain(timeout=120)
    if ctx.process_id == 0:
        with open(os.path.join(args["model_dir"], "done.json"), "w") as f:
            json.dump({"final_step": global_step, "resumed_from": resumed_from, "num_workers": num_workers,
                       "mesh": mesh_shape(strategy.mesh)}, f)


def _committed_steps(model_dir):
    """The steps of the committed checkpoints (``ckpt_<step>``) in ``model_dir``."""
    return [int(name[len("ckpt_"):]) for name in os.listdir(model_dir)
            if name.startswith("ckpt_") and name[len("ckpt_"):].isdigit()]


@pytest.mark.chaos
def test_preempt_drain_regrow_full_size_resume(tmp_path, monkeypatch):
    """The bidirectional acceptance story in a gloo world: one latched chaos
    kill takes the victim down → the ledger blacklists it
    (``blacklist_after=1``) and the ladder shrinks to 1 → the mid-run regrow
    poll re-probes the condemned executor, finds it healthy, and the scaler
    votes to grow → the driver posts a preemption warning, the shrunk worker
    drains its async checkpoint and exits clean (budget-exempt:
    ``max_relaunches=1`` is already spent on the kill) → the relaunch
    forgives the victim and regrows to the original world size,
    reshard-restoring the drained checkpoint onto the 2-rank mesh."""
    monkeypatch.setenv("TOS_MONITOR_INTERVAL", "1")
    monkeypatch.setenv("TOS_HEARTBEAT_INTERVAL", "0.2")
    chaos_log = str(tmp_path / "chaos.log")
    monkeypatch.setenv(chaos.LOG_ENV_VAR, chaos_log)
    model_dir = str(tmp_path / "model")
    os.makedirs(model_dir)
    latch = str(tmp_path / "kill.latch")
    args = {
        "model_dir": model_dir,
        "target_steps": 12,
        "hold": 6,
        "step_pace_secs": 0.05,
        "victim": 1,
        "latch": latch,
        "full_size": 2,
        "variables": _jax_variables(),
    }

    # once_path makes the kill a single event across the victim's lives:
    # the respawned (forgiven) child finds the latch and trains normally
    plan = chaos.ChaosPlan(seed=11).site(
        "node.kill", probability=1.0, max_count=1, victim=1, after_beats=25,
        once_path=latch,
    )
    chaos.install(plan)
    # the regrown life resumes from the drained checkpoint, so the story
    # needs the shrunk life past the target before the regrow: each poll
    # reports "not yet" until a checkpoint at the target is committed
    # (keyed on progress, not on the clock: under load the first poll came
    # before the shrunk life reached the target)
    poll = elastic._regrow_poll

    def poll_after_target(*a, **kw):
        if max(_committed_steps(model_dir), default=0) < args["target_steps"]:
            return False
        return poll(*a, **kw)

    monkeypatch.setattr(elastic, "_regrow_poll", poll_after_target)
    sc = LocalSparkContext(num_executors=2, task_timeout=900)
    try:
        result = elastic.run_ladder(
            sc, fn_regrow_train, args, num_executors=2,
            max_relaunches=1, min_workers=1, blacklist_after=1,
            regrow=True, regrow_check_secs=3.0,
            scaler=control.ClusterScaler(2, min_size=1, grow_patience=1),
            input_mode=InputMode.TENSORFLOW, master_node=None,
            env=CPU_ENV, jax_distributed=True, reservation_timeout=180,
            shutdown_timeout=240,
        )
    finally:
        sc.stop()
        chaos.uninstall()

    # the ladder's trajectory: kill → shrink to 1, preempt-drain → regrow
    # to 2 with the blacklist emptied by forgiveness. The preemption rode
    # for free: max_relaunches=1 was already spent on the kill, so the run
    # completing at all proves the budget exemption end to end.
    assert result.relaunches == 2
    assert result.num_executors == 2
    assert result.blacklist == set()
    kinds = [e.kind for _, e in result.events]
    assert "preemption" in kinds

    # exactly one kill ever fired (the latch held across lives)
    with open(chaos_log) as f:
        kills = [line for line in f if line.strip() == "node.kill"]
    assert len(kills) == 1

    # training completed back on the FULL mesh, resuming the trajectory the
    # preempted life drained (its async checkpoint outlived the process)
    with open(os.path.join(model_dir, "done.json")) as f:
        done = json.load(f)
    assert done["num_workers"] == 2
    assert done["mesh"] == {"dp": 1, "fsdp": 2}
    assert done["final_step"] >= args["target_steps"]
    assert done["resumed_from"] >= args["target_steps"], (
        "the regrown life must resume from the shrunk life's progress, "
        "not restart"
    )
    _assert_final_state(model_dir, done)

    # the bidirectional counters are in the merged snapshot
    snap = result.metrics
    assert snap is not None
    assert snap["counters"]["recovery_shrinks_total"]["value"] >= 1
    assert snap["counters"]["recovery_regrows_total"]["value"] >= 1
    assert snap["counters"]["preemptions_drained_total"]["value"] >= 1
    assert snap["gauges"]["target_world_size"]["value"] == 2
    assert snap["gauges"]["executors_blacklisted"]["value"] == 0


# -- the port's own: how a child the driver's abort ends reports ---------------


class _Channel:
    def __init__(self, **kv):
        self.kv = dict(kv)

    def get(self, key):
        return self.kv.get(key)

    def set(self, key, value):
        self.kv[key] = value


@pytest.mark.parametrize("posted,status", [
    ({}, "preempted"),
    ({"abort": "attempt 1 failed: node worker:1 failed (exit -9)"}, "aborted"),
    ({"released": True}, "released"),
])
def test_a_child_the_abort_terminates_commits_aborted_not_preempted(monkeypatch, posted, status):
    """SIGTERM reaches a trainer child three ways: a platform preemption
    warning, the executor releasing a parked role, and the driver's abort
    tearing down the survivors of a failed attempt. Only the first is a
    warned loss; an aborted survivor commits ``aborted`` (the watchdog
    journals it as a plain leave), not ``preempted``."""
    from tensorflowonspark_tpu_torch import TFSparkNode

    channel = _Channel(**posted)
    exits = []

    def fake_exit(code):
        exits.append(code)
        raise SystemExit(code)

    monkeypatch.setattr(TFSparkNode.os, "_exit", fake_exit)
    monkeypatch.setattr(TFSparkNode, "_preempt", dict(TFSparkNode._preempt, fired=False, mgr=channel,
                                                      publisher=None))
    with pytest.raises(SystemExit):
        TFSparkNode._preempt_drain("sigterm")
    assert channel.kv["child_status"] == status and exits == [143]


class _Stalled:
    """A running cluster whose driver registry holds an input pipeline's
    stall counters (the driver ran one itself) while its trainers report
    none: the merged snapshot reads ``io_bound``, the trainers' own
    ``device_bound``."""

    def __init__(self):
        self.warned = []

    def metrics(self, include_driver=True):
        counters = {}
        if include_driver:
            counters = {"data_producer_read_seconds_total": {"value": 0.136},
                        "data_consumer_wait_seconds_total": {"value": 0.072}}
        return {"counters": counters}

    def preempt(self, reason):
        self.warned.append(reason)
        return [0]


def test_the_regrow_gate_reads_the_trainers_input_path_not_the_drivers():
    """The regrow poll classifies the trainers' stall counters: a driver
    that ran an input pipeline itself (its registry says ``io_bound``) must
    not defer the regrow of trainers that starve for nothing."""
    cluster = _Stalled()
    scaler = control.ClusterScaler(2, min_size=1, grow_patience=1)
    assert elastic._regrow_poll(object(), cluster, scaler, {1}, 2, 1, None)
    assert len(cluster.warned) == 1 and "regrow to 2" in cluster.warned[0]
