"""Failure → relaunch → auto-resume on the port: the JAX package's
``tests/test_recovery.py``.

:func:`TFCluster.run_with_recovery` closes the loop driver-side: watchdog /
launch-error detection → :meth:`TFCluster.abort` (executor-side abort
watchers kill surviving trainer children, freeing the pinned executor slots)
→ relaunch → ``map_fun`` resumes from its latest checkpoint. The five cases
keep the reference's assertions, with ``map_fun`` functions on torch: the
MLP (16 hidden units, no dropout, SGD 0.1) from the JAX package's initial
weights. The TENSORFLOW-mode kill also holds the victim's final checkpoint
bitwise to an uninterrupted port run from the checkpoint it resumed, and
the survivor's to the JAX package's ``SyncDataParallel`` on the same rows
within 1e-5 (``test_torch_resume.py``'s limit). The SPARK-mode kill trains
on rows in the order the feed delivers them, which no reference run can
replay, so it keeps the reference's assertions only."""

import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_tpu import parallel as jax_parallel
from tensorflowonspark_tpu.models import mnist as jmnist
from tensorflowonspark_tpu.train import SyncDataParallel as JaxSyncDataParallel
from tensorflowonspark_tpu_torch import TFCluster, convert, util
from tensorflowonspark_tpu_torch.TFCluster import InputMode
from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
from tensorflowonspark_tpu_torch.models import mnist
from tensorflowonspark_tpu_torch.train import SyncDataParallel, checkpoint, optim

CPU_ENV = {util.ENV_PLATFORM: "cpu"}
MLP = dict(hidden=16, dropout_rate=0.0)
TOL = 1e-5


def _jax_variables():
    variables = jmnist.make_init_fn(jmnist.create_model("mlp", **MLP))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jax.device_get(variables))


def _rows():
    rng = np.random.default_rng(7)
    return {"image": rng.standard_normal((32, 28, 28)).astype(np.float32),
            "label": rng.integers(0, 10, 32)}


def _mlp(variables, device):
    """(strategy, state, step) of the MLP from ``variables``."""
    from tensorflowonspark_tpu_torch.models import mnist
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim

    strategy = SyncDataParallel(device)
    optimizer = optim.sgd(0.1)
    model = convert.load_variables(mnist.create_model("mlp", **MLP), variables)
    state = strategy.create_state(lambda: model, optimizer)
    step = strategy.compile_train_step(mnist.make_loss_fn(model), optimizer, has_aux=True)
    return strategy, state, step


def fn_train_resume_or_die(args, ctx):
    """Trains to ``target_steps`` total, checkpointing every
    ``checkpoint_steps``; the victim executor SIGKILLs itself at
    ``kill_at`` — once (a marker file makes the second life survive)."""
    import signal

    model_dir = os.path.join(args["model_dir"], "worker_{}".format(ctx.executor_id))
    os.makedirs(model_dir, exist_ok=True)
    strategy, state, step = _mlp(args["variables"], ctx.device)
    latest = checkpoint.latest_checkpoint(model_dir)
    if latest:
        checkpoint.restore_checkpoint(latest, target=state)
    global_step = state.step
    batch = strategy.shard_batch(_rows())
    marker = os.path.join(args["model_dir"], "killed.marker")
    while global_step < args["target_steps"]:
        state, metrics = step(state, batch)
        float(metrics["loss"])
        global_step += 1
        if global_step % args["checkpoint_steps"] == 0:
            checkpoint.save_checkpoint(os.path.join(model_dir, "ckpt_{}".format(global_step)), state)
        if (
            ctx.executor_id == args["victim"]
            and global_step == args["kill_at"]
            and not os.path.exists(marker)
        ):
            with open(marker, "w") as f:
                f.write("first life died here")
            os.kill(os.getpid(), signal.SIGKILL)  # no traceback, no cleanup
    with open(os.path.join(model_dir, "done.json"), "w") as f:
        json.dump({"final_step": global_step}, f)


def test_sigkilled_child_training_finishes_anyway(tmp_path, monkeypatch):
    monkeypatch.setenv("TOS_MONITOR_INTERVAL", "1")
    model_dir = str(tmp_path)
    args = {
        "model_dir": model_dir,
        "target_steps": 8,
        "checkpoint_steps": 2,
        "kill_at": 5,  # after the step-4 checkpoint, before step-6
        "victim": 1,
        "variables": _jax_variables(),
    }
    sc = LocalSparkContext(num_executors=2, task_timeout=600)
    try:
        relaunches = TFCluster.run_with_recovery(
            sc, fn_train_resume_or_die, args, num_executors=2,
            input_mode=InputMode.TENSORFLOW, master_node=None,
            env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
            max_relaunches=2, shutdown_timeout=240,
        )
    finally:
        sc.stop()
    assert relaunches == 1, "exactly one relaunch should recover this run"
    # the victim really died mid-train ...
    assert os.path.exists(os.path.join(model_dir, "killed.marker"))
    # ... yet BOTH workers finished the full training
    for eid in (0, 1):
        with open(os.path.join(model_dir, "worker_{}".format(eid), "done.json")) as f:
            assert json.load(f)["final_step"] == args["target_steps"]
    # the victim resumed from its step-4 checkpoint (not from scratch): its
    # second life added the 6 and 8 checkpoints on top of 2 and 4
    victim_ckpts = sorted(
        d for d in os.listdir(os.path.join(model_dir, "worker_1")) if d.startswith("ckpt_")
    )
    assert victim_ckpts == ["ckpt_2", "ckpt_4", "ckpt_6", "ckpt_8"]

    # the resumed run equals an uninterrupted port run from its step-4
    # checkpoint, bitwise (on the CPU threads each of the host's two
    # trainers took: the sums' blocking follows the thread count), and the
    # survivor the JAX package within TOL
    strategy, state, step = _mlp(args["variables"], "cpu")
    checkpoint.restore_checkpoint(os.path.join(model_dir, "worker_1", "ckpt_4"), target=state)
    batch = strategy.shard_batch(_rows())
    threads = torch.get_num_threads()
    torch.set_num_threads(util.cpu_share(2))
    try:
        for _ in range(4):
            state, _ = step(state, batch)
    finally:
        torch.set_num_threads(threads)
    victim = checkpoint.restore_checkpoint(os.path.join(model_dir, "worker_1", "ckpt_8"))
    assert victim["step"] == state.step == 8
    for name, value in state.params.items():
        assert torch.equal(victim["params"][name], value.detach()), name
    jmodel = jmnist.create_model("mlp", **MLP)
    jstrategy = JaxSyncDataParallel(jax_parallel.build_mesh({"dp": 1}, devices=jax.devices()[:1]))
    tx = optax.sgd(0.1)
    jstate = jstrategy.create_state(lambda: args["variables"], tx)
    jstep = jstrategy.compile_train_step(jmnist.make_loss_fn(jmodel), tx, has_aux=True, donate=False)
    jbatch = jstrategy.shard_batch(_rows())
    for _ in range(args["target_steps"]):
        jstate, _ = jstep(jstate, jbatch)
    want = convert.convert_variables({"params": jax.tree.map(np.asarray, jax.device_get(jstate.params))},
                                     state.module)
    survivor = checkpoint.restore_checkpoint(os.path.join(model_dir, "worker_0", "ckpt_8"))
    gap = max(float((survivor["params"][n] - want[n]).abs().max()) for n in want)
    assert gap <= TOL, gap


def fn_touch_and_exit(args, ctx):
    with open(os.path.join(args["dir"], "ran_{}".format(ctx.executor_id)), "w") as f:
        f.write(ctx.job_name)


def test_run_with_recovery_completes_with_parked_ps_role(tmp_path):
    """A ps task parks on its control queue until shutdown, so the launch job
    outlives training by design — completion must key off worker channel
    state, not launch-thread death (this hung before wait_for_completion)."""
    d = str(tmp_path)
    sc = LocalSparkContext(num_executors=2, task_timeout=300)
    try:
        relaunches = TFCluster.run_with_recovery(
            sc, fn_touch_and_exit, {"dir": d}, num_executors=2, num_ps=1,
            input_mode=InputMode.TENSORFLOW, master_node=None,
            env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
            max_relaunches=0, shutdown_timeout=120,
        )
    finally:
        sc.stop()
    assert relaunches == 0
    # the WORKER ran to completion. (No assertion on the ps node's file: ps
    # is a service role — shutdown terminates its child the moment the
    # workers finish, which can be before a slow-booting ps child even
    # reaches user code; the reference's ps sat in server.join() and was
    # killed the same way, TFSparkNode.py:373-390.)
    assert "ran_1" in os.listdir(d)


def test_run_with_recovery_rejects_spark_mode_without_feed_fn():
    with pytest.raises(ValueError, match="feed_fn"):
        TFCluster.run_with_recovery(
            None, lambda a, c: None, {}, num_executors=1,
            input_mode=InputMode.SPARK,
        )


def test_run_with_recovery_rejects_feed_fn_in_tensorflow_mode():
    with pytest.raises(ValueError, match="InputMode.SPARK"):
        TFCluster.run_with_recovery(
            None, lambda a, c: None, {}, num_executors=1,
            input_mode=InputMode.TENSORFLOW, feed_fn=lambda cluster: None,
        )


def fn_spark_feed_resume_or_die(args, ctx):
    """SPARK-mode twin of :func:`fn_train_resume_or_die`: trains one step per
    fed batch to ``target_steps`` total across lives, checkpointing every
    ``checkpoint_steps``; the victim SIGKILLs itself at ``kill_at`` — once."""
    import signal

    model_dir = os.path.join(args["model_dir"], "worker_{}".format(ctx.executor_id))
    os.makedirs(model_dir, exist_ok=True)
    strategy, state, step = _mlp(args["variables"], ctx.device)
    latest = checkpoint.latest_checkpoint(model_dir)
    if latest:
        checkpoint.restore_checkpoint(latest, target=state)
    global_step = state.step
    marker = os.path.join(args["model_dir"], "killed.marker")
    feed = ctx.get_data_feed(train_mode=True)
    while not feed.should_stop() and global_step < args["target_steps"]:
        rows = feed.next_batch(16)
        if not rows:
            continue
        images = np.asarray([r[0] for r in rows], np.float32).reshape(-1, 28, 28)
        labels = np.asarray([r[1] for r in rows])
        state, metrics = step(state, strategy.shard_batch({"image": images, "label": labels}))
        float(metrics["loss"])
        global_step += 1
        if global_step % args["checkpoint_steps"] == 0:
            checkpoint.save_checkpoint(os.path.join(model_dir, "ckpt_{}".format(global_step)), state)
        if (
            ctx.executor_id == args["victim"]
            and global_step == args["kill_at"]
            and not os.path.exists(marker)
        ):
            with open(marker, "w") as f:
                f.write("first life died here")
            os.kill(os.getpid(), signal.SIGKILL)  # no traceback, no cleanup
    feed.terminate()  # drain the rest of the feed so feeders can finish
    with open(os.path.join(model_dir, "done.json"), "w") as f:
        json.dump({"final_step": global_step}, f)


@pytest.mark.slow
def test_spark_feed_killed_node_training_finishes_anyway(tmp_path, monkeypatch):
    """Kill a node mid-SPARK-feed; run_with_recovery re-invokes the caller's
    feed_fn against the relaunched cluster and both workers finish training,
    the victim resuming from its checkpoint. Slow, as the reference's: the
    feed task bound for the dead node surfaces the loss only at its 120 s
    ``feed_timeout`` (~145 s a run on the CPU)."""
    monkeypatch.setenv("TOS_MONITOR_INTERVAL", "1")
    model_dir = str(tmp_path)
    args = {
        "model_dir": model_dir,
        "target_steps": 8,
        "checkpoint_steps": 2,
        "kill_at": 5,  # after the step-4 checkpoint, before step-6
        "victim": 1,
        "variables": _jax_variables(),
    }
    rng = np.random.default_rng(3)
    rows = [
        (rng.standard_normal(784).astype(np.float32).tolist(), int(i % 10))
        for i in range(128)
    ]
    feeds = []

    sc = LocalSparkContext(num_executors=2, task_timeout=900)

    def all_done():
        return all(
            os.path.exists(os.path.join(model_dir, "worker_{}".format(e), "done.json"))
            for e in (0, 1)
        )

    def feed_fn(cluster):
        """The caller's feed loop: waves until every worker reports done.
        A single big feed would under-serve the victim's second life — a
        worker that reaches its target terminates its node, and later feed
        tasks landing on that executor discard their partitions by design
        ('training said enough'), so the data a straggler still needs must
        keep coming from the CALLER. This re-feed-until-done shape is
        exactly why SPARK-mode recovery needs feed_fn (the RDD lineage and
        the stop condition both belong to the caller)."""
        feeds.append(1)  # prove the helper re-invoked the caller's loop
        while not all_done():
            cluster.check_errors()
            cluster.train(sc.parallelize(rows, 4), num_epochs=1, feed_timeout=120)

    try:
        relaunches = TFCluster.run_with_recovery(
            sc, fn_spark_feed_resume_or_die, args, num_executors=2,
            input_mode=InputMode.SPARK, master_node=None,
            env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
            max_relaunches=2, shutdown_timeout=240, feed_fn=feed_fn,
        )
    finally:
        sc.stop()
    assert relaunches == 1, "exactly one relaunch should recover this run"
    assert len(feeds) == 2  # the feed loop ran once per attempt
    assert os.path.exists(os.path.join(model_dir, "killed.marker"))
    for eid in (0, 1):
        with open(os.path.join(model_dir, "worker_{}".format(eid), "done.json")) as f:
            assert json.load(f)["final_step"] == args["target_steps"]
    # the victim resumed from its step-4 checkpoint, not from scratch
    victim_ckpts = sorted(
        d for d in os.listdir(os.path.join(model_dir, "worker_1")) if d.startswith("ckpt_")
    )
    assert victim_ckpts == ["ckpt_2", "ckpt_4", "ckpt_6", "ckpt_8"]
