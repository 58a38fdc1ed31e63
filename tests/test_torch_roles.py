"""ps and evaluator roles end to end on the port — ``tests/test_roles.py``
with the package name rewritten and the ``map_fun``s written on torch.

A cluster with ``num_ps=1, eval_node=True``: the chief trains from the feed
and writes checkpoints, the evaluator evaluates the latest checkpoint as it
appears, the ps parks (an API-compat role), and the driver's shutdown
releases both parked roles. An evaluator that fails surfaces its error at
``cluster.shutdown()``.
"""

import json
import os
import time

import pytest

from tensorflowonspark_tpu_torch import TFCluster, util
from tensorflowonspark_tpu_torch.TFCluster import InputMode
from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext

CPU_ENV = {util.ENV_PLATFORM: "cpu"}


def fn_role_dispatch(args, ctx):
    """main_fun for every role, dispatching like reference user programs."""
    out_dir = args["out_dir"]
    marker = os.path.join(out_dir, "{}-{}.started".format(ctx.job_name, ctx.task_index))
    with open(marker, "w") as f:
        f.write(str(os.getpid()))

    if ctx.job_name == "ps":
        # no parameter server in the port: park until the driver releases the role
        while True:
            time.sleep(0.2)

    if ctx.job_name == "evaluator":
        _evaluator_loop(args, ctx)
        return

    _chief_train(args, ctx)


def _evaluator_loop(args, ctx):
    """Evaluate every new checkpoint as it appears (runs until terminated)."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.models import mnist
    from tensorflowonspark_tpu_torch.train import checkpoint

    model = mnist.create_model("mlp").to(ctx.device).eval()
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.standard_normal((64, 28, 28)).astype(np.float32)).to(ctx.device)
    labels = rng.integers(0, 10, 64)
    seen = set()
    while True:
        latest = checkpoint.latest_checkpoint(args["model_dir"])
        if latest and latest not in seen:
            seen.add(latest)
            state = checkpoint.restore_checkpoint(latest)
            model.load_state_dict(state["params"])
            with torch.no_grad():
                pred = model(images).argmax(-1).cpu().numpy()
            acc = float(np.mean(pred == labels))
            record = {"checkpoint": os.path.basename(latest), "accuracy": acc, "step": int(state["step"])}
            with open(os.path.join(args["out_dir"], "eval-{}.json".format(len(seen))), "w") as f:
                json.dump(record, f)
        time.sleep(0.2)


def _chief_train(args, ctx):
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.models import mnist
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, checkpoint, optim

    strategy = SyncDataParallel(ctx.device)
    model = mnist.create_model("mlp")
    optimizer = optim.sgd(0.1)
    state = strategy.create_state(mnist.make_init_fn(model), optimizer, torch.Generator().manual_seed(0))
    step = strategy.compile_train_step(mnist.make_loss_fn(model), optimizer, has_aux=True)
    feed = ctx.get_data_feed(train_mode=True)
    steps = 0
    while not feed.should_stop():
        batch = feed.next_batch(32)
        if not batch:
            break
        images = np.asarray([b[0] for b in batch], np.float32).reshape(-1, 28, 28)
        labels = np.asarray([b[1] for b in batch])
        state, _ = step(state, strategy.shard_batch({"image": images, "label": labels}))
        steps += 1
        if steps % 4 == 0:
            checkpoint.save_checkpoint(os.path.join(args["model_dir"], "ckpt_{}".format(steps)), state)


def test_ps_and_evaluator_roles(tmp_path):
    out_dir = str(tmp_path / "out")
    model_dir = str(tmp_path / "model")
    os.makedirs(out_dir)
    sc = LocalSparkContext(num_executors=3, task_timeout=300)
    try:
        cluster = TFCluster.run(
            sc, fn_role_dispatch, {"out_dir": out_dir, "model_dir": model_dir},
            num_executors=3, num_ps=1, master_node="chief", eval_node=True,
            input_mode=InputMode.SPARK, env=CPU_ENV, jax_distributed=False,
            reservation_timeout=120,
        )
        # template: executor 0 = ps, 1 = chief, 2 = evaluator
        roles = {(r["job_name"], r["task_index"]) for r in cluster.cluster_info}
        assert roles == {("ps", 0), ("chief", 0), ("evaluator", 0)}

        rng_rows = [([0.01 * (i % 100)] * 784, i % 10) for i in range(512)]
        cluster.train(sc.parallelize(rng_rows, 4), num_epochs=1, feed_timeout=240)

        # evaluator must observe at least one checkpoint before teardown
        deadline = time.time() + 120
        while time.time() < deadline:
            if any(n.startswith("eval-") for n in os.listdir(out_dir)):
                break
            time.sleep(0.5)

        t0 = time.time()
        cluster.shutdown(grace_secs=2, timeout=240)
        teardown = time.time() - t0
    finally:
        sc.stop()

    started = sorted(n for n in os.listdir(out_dir) if n.endswith(".started"))
    assert started == ["chief-0.started", "evaluator-0.started", "ps-0.started"]
    evals = [n for n in os.listdir(out_dir) if n.startswith("eval-")]
    assert evals, "evaluator produced no eval results"
    with open(os.path.join(out_dir, sorted(evals)[0])) as f:
        record = json.load(f)
    assert record["checkpoint"].startswith("ckpt_")
    assert 0.0 <= record["accuracy"] <= 1.0
    assert record["step"] >= 4
    # parked ps/evaluator roles were released promptly, not via the 3-day
    # watchdog (reference TFCluster.py:136-144)
    assert teardown < 120, teardown


def fn_evaluator_crashes(args, ctx):
    if ctx.job_name == "evaluator":
        raise RuntimeError("deliberate evaluator failure")
    feed = ctx.get_data_feed(train_mode=True)
    while not feed.should_stop():
        feed.next_batch(16)


def test_evaluator_error_surfaces_at_shutdown(tmp_path):
    """A crashed driver-managed role must fail shutdown, not be swallowed
    (its error queue has no feed task to surface it through)."""
    sc = LocalSparkContext(num_executors=2, task_timeout=240)
    try:
        cluster = TFCluster.run(
            sc, fn_evaluator_crashes, {}, num_executors=2,
            master_node="chief", eval_node=True,
            input_mode=InputMode.SPARK, env=CPU_ENV, jax_distributed=False,
            reservation_timeout=120,
        )
        cluster.train(sc.parallelize(range(64), 2), num_epochs=1, feed_timeout=120)
        # deterministic: wait until the evaluator child has actually crashed
        # (posted its traceback) before shutdown peeks the error queues —
        # under load the spawned child may still be importing
        from tensorflowonspark_tpu_torch import TFManager

        row = next(r for r in cluster.cluster_info if r["job_name"] == "evaluator")
        mgr = TFManager.connect(tuple(row["manager_addr"]), cluster.cluster_meta["authkey"])
        deadline = time.time() + 120
        while mgr.get("child_status") != "failed" and time.time() < deadline:
            time.sleep(0.2)
        assert mgr.get("child_status") == "failed"
        with pytest.raises(RuntimeError, match="deliberate evaluator failure"):
            cluster.shutdown(grace_secs=1, timeout=240)
    finally:
        sc.stop()


def fn_park_evaluator(args, ctx):
    with open(os.path.join(args["out_dir"], "{}.started".format(ctx.job_name)), "w") as f:
        f.write(str(os.getpid()))
    if ctx.job_name == "evaluator":
        while True:
            time.sleep(0.2)
    feed = ctx.get_data_feed(train_mode=True)
    while not feed.should_stop():
        if not feed.next_batch(16):
            break


def test_released_evaluator_is_not_a_preemption(tmp_path):
    """The executor releases a parked evaluator at shutdown with SIGTERM,
    the signal of a preemption warning; it marks the release on the channel
    first, so the child commits ``released`` and shutdown does not report
    the evaluator as preempted."""
    from tensorflowonspark_tpu_torch import TFManager, TFSparkNode

    out_dir = str(tmp_path)
    sc = LocalSparkContext(num_executors=2, task_timeout=240)
    try:
        cluster = TFCluster.run(
            sc, fn_park_evaluator, {"out_dir": out_dir}, num_executors=2,
            master_node="chief", eval_node=True,
            input_mode=InputMode.SPARK, env=CPU_ENV, jax_distributed=False,
            reservation_timeout=120,
        )
        row = next(r for r in cluster.cluster_info if r["job_name"] == "evaluator")
        mgr = TFManager.connect(tuple(row["manager_addr"]), cluster.cluster_meta["authkey"])
        deadline = time.time() + 120  # the child's SIGTERM handler is armed before fn runs
        while not os.path.exists(os.path.join(out_dir, "evaluator.started")) and time.time() < deadline:
            time.sleep(0.2)
        cluster.train(sc.parallelize(range(32), 2), num_epochs=1, feed_timeout=120)
        cluster.shutdown(grace_secs=1, timeout=240)
        assert mgr.get(TFSparkNode.RELEASED_KEY) is True
        assert mgr.get("child_status") == "released"
    finally:
        sc.stop()
