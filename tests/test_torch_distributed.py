"""Multi-process torch.distributed execution — the port of the JAX package's
``tests/test_jax_distributed.py``, its children rewritten on torch.

Here ≥2 OS processes each join one gloo world (``torch.distributed``) via
the reservation-derived world, one CPU device a rank, and run synchronous
data-parallel train steps whose loss must agree across processes (it is a
global collective) and match a single-process run on the same global batch.
Covers ``shard_batch`` in a world: each rank places its own local rows.

The JAX package gave each process two virtual CPU devices
(``TOS_NUM_CPU_DEVICES=2``); a torch rank holds one device, so the world of
two processes has two devices, not four. The MLP trains without dropout: a
rank draws its own masks, so dropout on would differ from a single process
drawing the whole batch's.
"""

import json
import os

import numpy as np
import pytest

from tensorflowonspark_tpu_torch import TFCluster, util
from tensorflowonspark_tpu_torch.TFCluster import InputMode
from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext

CPU_ENV = {util.ENV_PLATFORM: "cpu"}


def _deterministic_batch(n):
    """(images, labels) fixed by row index — identical in every process."""
    images = (np.arange(n * 28 * 28, dtype=np.float32).reshape(n, 28, 28) % 255.0) / 255.0
    labels = np.arange(n) % 10
    return images, labels


def _strategy_and_step():
    """The MLP (no dropout), plain SGD 0.1, weights from seed 0, through
    ``SyncDataParallel`` on the CPU: over the whole world when one is up."""
    import torch

    from tensorflowonspark_tpu_torch.models import mnist
    from tensorflowonspark_tpu_torch.train import SyncDataParallel, optim

    strategy = SyncDataParallel(torch.device("cpu"))
    model = mnist.create_model("mlp", dropout_rate=0.0)
    optimizer = optim.sgd(0.1)
    state = strategy.create_state(mnist.make_init_fn(model), optimizer, torch.Generator().manual_seed(0))
    step = strategy.compile_train_step(mnist.make_loss_fn(model), optimizer, has_aux=True)
    return strategy, state, step


def _train_losses(ctx_args):
    """Body shared by the direct two-process world and the reference
    single-process run: 3 mnist-MLP train steps on a fixed global batch of
    16 rows; this process contributes rows [lo:hi). Returns the loss list.
    """
    lo, hi = ctx_args["rows"]
    strategy, state, step = _strategy_and_step()

    images, labels = _deterministic_batch(16)
    local = {"image": images[lo:hi], "label": labels[lo:hi]}
    losses = []
    for _ in range(3):
        state, metrics = step(state, strategy.shard_batch(local))
        losses.append(float(metrics["loss"]))
    return losses


def _world():
    """(processes, devices) of the live world: one device a rank."""
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.parallel.mesh import world_devices

    return dist.get_world_size(), len(world_devices())


def _world_child(pid, num_procs, coord_port, rows, out_dir):
    """Entry of one spawned world member (module-level: spawn-picklable)."""
    from tensorflowonspark_tpu_torch.testing import join_cpu_world

    join_cpu_world(pid, num_procs, coord_port)
    process_count, device_count = _world()

    assert process_count == num_procs, process_count
    assert device_count == num_procs, device_count
    losses = _train_losses({"rows": rows})
    with open(os.path.join(out_dir, "proc{}.json".format(pid)), "w") as f:
        json.dump({"pid": pid, "losses": losses}, f)


@pytest.mark.parametrize("num_procs", [2])
def test_two_process_world_matches_single_process(tmp_path, num_procs):
    """2 OS processes × 1 CPU device = one 2-device world; per-step losses
    agree across processes and with a single-process run on the full batch."""
    import functools

    coord_port = util.find_free_port()
    per = 16 // num_procs
    procs = [
        util.spawn_process(
            functools.partial(
                _world_child, pid, num_procs, coord_port, (pid * per, (pid + 1) * per), str(tmp_path)
            ),
            name="world-{}".format(pid),
        )
        for pid in range(num_procs)
    ]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]

    results = []
    for pid in range(num_procs):
        with open(tmp_path / "proc{}.json".format(pid)) as f:
            results.append(json.load(f)["losses"])
    # the loss is a global collective: every process must report the same value
    for other in results[1:]:
        assert np.allclose(results[0], other, rtol=1e-5), results

    # and it must equal the single-process result on the same global batch
    reference = _train_losses({"rows": (0, 16)})
    assert np.allclose(results[0], reference, rtol=1e-4, atol=1e-5), (results[0], reference)
    # training actually progressed
    assert reference[-1] < reference[0]


def fn_distributed_train(args, ctx):
    """main_fun for the cluster-level test: the trainer child was already
    initialized into the distributed world by the node runtime."""
    process_count, device_count = _world()
    out = {
        "executor_id": ctx.executor_id,
        "process_count": process_count,
        "device_count": device_count,
        "losses": _train_losses({"rows": (ctx.process_id * 8, ctx.process_id * 8 + 8)}),
    }
    with open(os.path.join(args["out_dir"], "node{}.json".format(ctx.executor_id)), "w") as f:
        json.dump(out, f)


def fn_spark_feed_distributed(args, ctx):
    """SPARK-mode distributed consumer: each process trains from its OWN
    feed queue, contributing its local rows to the global batch (inside
    ``shard_batch``)."""
    strategy, state, step = _strategy_and_step()
    feed = ctx.get_data_feed(train_mode=True)
    losses = []
    for _ in range(args["steps"]):
        batch = feed.next_batch(args["batch_size"])
        images = np.asarray([b[0] for b in batch], np.float32).reshape(-1, 28, 28)
        labels = np.asarray([int(b[1]) for b in batch])
        state, metrics = step(
            state, strategy.shard_batch({"image": images, "label": labels})
        )
        losses.append(float(metrics["loss"]))
    # uneven partitions leave unconsumed rows; terminate drains them so the
    # blocked feed tasks can finish (the steps_per_worker safeguard story)
    feed.terminate()
    process_count, device_count = _world()
    out = {
        "executor_id": ctx.executor_id,
        "process_count": process_count,
        "device_count": device_count,
        "losses": losses,
    }
    with open(os.path.join(args["out_dir"], "node{}.json".format(ctx.executor_id)), "w") as f:
        json.dump(out, f)


def test_spark_mode_distributed_training_with_uneven_partitions(tmp_path):
    """SURVEY §7 hard-parts 3/4 in one test: a 2-worker
    InputMode.SPARK cluster whose trainer children join ONE collective world
    and train from their own feed queues, fed from deliberately uneven RDD
    partitions; the per-step loss is a global collective and must agree.
    The CPU twin of ``examples/cluster_check.py``'s ``mnist_spark_dp4``."""
    from tensorflowonspark_tpu_torch.train import steps_per_worker

    rows = []
    images, labels = _deterministic_batch(40)
    for i in range(40):
        rows.append((images[i].reshape(-1).tolist(), int(labels[i])))
    # uneven partitions: sizes 16/12/8/4, pinned so each executor gets 20 rows
    parts = [rows[:16], rows[16:28], rows[28:36], rows[36:40]]
    flat = [r for part in parts for r in part]
    batch_size = 4
    steps = steps_per_worker(len(rows), batch_size, 2)  # floor(5)*0.9 = 4

    sc = LocalSparkContext(num_executors=2, task_timeout=240)
    try:
        cluster = TFCluster.run(
            sc, fn_spark_feed_distributed,
            {"out_dir": str(tmp_path), "steps": steps, "batch_size": batch_size},
            num_executors=2, input_mode=InputMode.SPARK, master_node=None,
            env=CPU_ENV, jax_distributed=True, reservation_timeout=180,
        )
        rdd = sc.parallelize(flat, 4, pin_to_executors=[0, 1, 1, 0])
        # re-slice into the original uneven partitions (local backend RDD
        # partitions are (data, transform_chain) pairs)
        rdd._parts = [(p, ()) for p in parts]
        cluster.train(rdd, num_epochs=1, feed_timeout=120)
        cluster.shutdown(grace_secs=2, timeout=300)
    finally:
        sc.stop()

    reports = []
    for eid in range(2):
        with open(tmp_path / "node{}.json".format(eid)) as f:
            reports.append(json.load(f))
    assert all(r["process_count"] == 2 for r in reports), reports
    assert all(r["device_count"] == 2 for r in reports), reports
    assert all(len(r["losses"]) == steps for r in reports), reports
    # collective loss: both processes must report identical values
    assert np.allclose(reports[0]["losses"], reports[1]["losses"], rtol=1e-5), reports


def test_cluster_forms_distributed_world(tmp_path):
    """TFCluster.run with jax_distributed=True (no CPU auto-disable): the two
    trainer children join one world derived from the reservations and train
    over it; their collective losses agree."""
    sc = LocalSparkContext(num_executors=2, task_timeout=240)
    try:
        cluster = TFCluster.run(
            sc, fn_distributed_train, {"out_dir": str(tmp_path)}, num_executors=2,
            input_mode=InputMode.TENSORFLOW, master_node=None,
            env=CPU_ENV, jax_distributed=True, reservation_timeout=180,
        )
        cluster.shutdown(timeout=300)
    finally:
        sc.stop()
    reports = []
    for eid in range(2):
        with open(tmp_path / "node{}.json".format(eid)) as f:
            reports.append(json.load(f))
    assert all(r["process_count"] == 2 for r in reports), reports
    assert all(r["device_count"] == 2 for r in reports), reports
    assert np.allclose(reports[0]["losses"], reports[1]["losses"], rtol=1e-5), reports
