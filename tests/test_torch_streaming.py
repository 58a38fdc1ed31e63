"""Streaming (DStream-equivalent) micro-batch feeding. Batches arrive in
waves, training proceeds between them, external STOP works, and shutdown
drains without deadlock (reference analogues:
TFCluster.py:83-85 DStream branch, mnist_spark_streaming.py,
utils/stop_streaming.py).
"""

import json
import os
import time

import pytest

from tensorflowonspark_tpu_torch import TFCluster, reservation, util
from tensorflowonspark_tpu_torch.TFCluster import InputMode
from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext, LocalStreamingContext

CPU_ENV = {util.ENV_PLATFORM: "cpu"}


@pytest.fixture
def sc():
    ctx = LocalSparkContext(num_executors=2, task_timeout=240)
    yield ctx
    ctx.stop()


def fn_count_rows(args, ctx):
    """Consumes the stream until end-of-feed; records its row total."""
    feed = ctx.get_data_feed(train_mode=True)
    total = 0
    while not feed.should_stop():
        batch = feed.next_batch(16)
        total += len(batch)
    with open(os.path.join(args["out_dir"], "node{}.json".format(ctx.executor_id)), "w") as f:
        json.dump({"rows": total}, f)


def _totals(out_dir, n):
    total = 0
    for eid in range(n):
        with open(os.path.join(out_dir, "node{}.json".format(eid))) as f:
            total += json.load(f)["rows"]
    return total


def test_waves_then_clean_shutdown(sc, tmp_path):
    """Micro-batches arriving in waves are all consumed; shutdown drains."""
    cluster = TFCluster.run(
        sc, fn_count_rows, {"out_dir": str(tmp_path)}, num_executors=2,
        input_mode=InputMode.SPARK, master_node=None,
        env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
    )
    ssc = LocalStreamingContext(sc, batch_interval=0.2)
    stream = ssc.queueStream()
    cluster.train(stream)
    ssc.start()
    for wave in range(3):
        ssc.feed(sc.parallelize(range(wave * 64, (wave + 1) * 64), 2))
        time.sleep(0.3)
    cluster.shutdown(ssc=ssc, grace_secs=2, timeout=240)
    assert _totals(str(tmp_path), 2) == 3 * 64


def test_generator_of_rdds(sc, tmp_path):
    """cluster.train also accepts a plain iterable of RDDs."""
    cluster = TFCluster.run(
        sc, fn_count_rows, {"out_dir": str(tmp_path)}, num_executors=2,
        input_mode=InputMode.SPARK, master_node=None,
        env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
    )

    def waves():
        for wave in range(4):
            yield sc.parallelize(range(32), 2)

    cluster.train(waves())
    cluster.shutdown(grace_secs=2, timeout=240)
    assert _totals(str(tmp_path), 2) == 4 * 32


def test_external_stop_ends_stream(sc, tmp_path):
    """utils/stop_cluster-style STOP on the control plane halts the feed."""
    cluster = TFCluster.run(
        sc, fn_count_rows, {"out_dir": str(tmp_path)}, num_executors=2,
        input_mode=InputMode.SPARK, master_node=None,
        env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
    )
    ssc = LocalStreamingContext(sc, batch_interval=0.2)
    stream = ssc.queueStream()
    cluster.train(stream)
    ssc.start()
    ssc.feed(sc.parallelize(range(64), 2))
    time.sleep(0.5)

    # external stop (the reference's utils/stop_streaming.py flow)
    reservation.Client(cluster.cluster_meta["server_addr"]).request_stop()
    assert cluster.stop_requested
    # micro-batches after the stop are NOT fed
    ssc.feed(sc.parallelize(range(64), 2))
    time.sleep(0.5)

    cluster.shutdown(ssc=ssc, grace_secs=2, timeout=240)
    assert _totals(str(tmp_path), 2) == 64
