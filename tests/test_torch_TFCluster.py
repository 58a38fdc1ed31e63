"""End-to-end cluster lifecycle tests on the local multi-process backend
(mirrors reference test/test_TFCluster.py: single-node fn, InputMode.SPARK
inference round trip, feed-error surfacing, late-error surfacing)."""

import os

import pytest

from tensorflowonspark_tpu_torch import TFCluster, util
from tensorflowonspark_tpu_torch.TFCluster import InputMode
from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext, TaskError

CPU_ENV = {util.ENV_PLATFORM: "cpu"}


@pytest.fixture
def sc():
    ctx = LocalSparkContext(num_executors=2, task_timeout=120)
    yield ctx
    ctx.stop()


def fn_write_marker(args, ctx):
    # runs in the jax child of each node; proves InputMode.TENSORFLOW dispatch
    path = os.path.join(args["out_dir"], "node-{}-{}.txt".format(ctx.job_name, ctx.task_index))
    with open(path, "w") as f:
        f.write("worker_num={} num_workers={}".format(ctx.executor_id, ctx.num_workers))


def fn_square_feed(args, ctx):
    feed = ctx.get_data_feed(train_mode=False)
    while not feed.should_stop():
        batch = feed.next_batch(16)
        if batch:
            feed.batch_results([x * x for x in batch])


def fn_square_feed_torch(args, ctx):
    import torch

    feed = ctx.get_data_feed(train_mode=False)
    while not feed.should_stop():
        batch = feed.next_batch(16, as_numpy=True)
        if batch.size:
            feed.batch_results([int(v) for v in torch.square(torch.from_numpy(batch))])


def fn_immediate_error(args, ctx):
    raise RuntimeError("deliberate failure before consuming feed")


def fn_late_error(args, ctx):
    feed = ctx.get_data_feed(train_mode=False)
    while not feed.should_stop():
        feed.next_batch(16)
    raise RuntimeError("deliberate failure after feeding finished")


def fn_consume_all(args, ctx):
    feed = ctx.get_data_feed()
    while not feed.should_stop():
        feed.next_batch(16)


class TestTFCluster:
    def test_single_node_tensorflow_mode(self, sc, tmp_path):
        cluster = TFCluster.run(
            sc, fn_write_marker, {"out_dir": str(tmp_path)}, num_executors=2,
            input_mode=InputMode.TENSORFLOW, master_node=None,
            env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
        )
        cluster.shutdown(timeout=120)
        files = sorted(os.listdir(str(tmp_path)))
        assert files == ["node-worker-0.txt", "node-worker-1.txt"]

    def test_inference_roundtrip(self, sc):
        cluster = TFCluster.run(
            sc, fn_square_feed, {}, num_executors=2,
            input_mode=InputMode.SPARK, master_node=None,
            env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
        )
        data = sc.parallelize(range(100), 4)
        results = cluster.inference(data).collect()
        cluster.shutdown(timeout=120)
        assert len(results) == 100
        assert sorted(results) == sorted(x * x for x in range(100))

    def test_inference_roundtrip_torch(self, sc):
        cluster = TFCluster.run(
            sc, fn_square_feed_torch, {}, num_executors=2,
            input_mode=InputMode.SPARK, master_node=None,
            env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
        )
        data = sc.parallelize(range(40), 2)
        results = cluster.inference(data, feed_timeout=300).collect()
        cluster.shutdown(timeout=300)
        assert sorted(results) == sorted(x * x for x in range(40))

    def test_feed_error_surfaces(self, sc):
        cluster = TFCluster.run(
            sc, fn_immediate_error, {}, num_executors=2,
            input_mode=InputMode.SPARK, master_node=None,
            env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
        )
        with pytest.raises(TaskError, match="deliberate failure before"):
            cluster.train(sc.parallelize(range(1000), 4), feed_timeout=30)
        with pytest.raises(RuntimeError):
            cluster.shutdown(timeout=120)

    def test_late_error_surfaces_at_shutdown(self, sc):
        cluster = TFCluster.run(
            sc, fn_late_error, {}, num_executors=2,
            input_mode=InputMode.SPARK, master_node=None,
            env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
        )
        cluster.train(sc.parallelize(range(64), 2), feed_timeout=60)
        with pytest.raises((TaskError, RuntimeError), match="after feeding finished"):
            cluster.shutdown(timeout=120)

    def test_train_and_clean_shutdown(self, sc):
        cluster = TFCluster.run(
            sc, fn_consume_all, {}, num_executors=2,
            input_mode=InputMode.SPARK, master_node=None,
            env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
        )
        cluster.train(sc.parallelize(range(200), 4), num_epochs=2, feed_timeout=60)
        cluster.shutdown(timeout=120)

    def test_shutdown_falls_back_to_spark_tasks(self, sc):
        """With the driver->executor TCP route severed (NAT'd clusters), the
        end-of-feed markers arrive via scattered Spark shutdown tasks over
        the executor-LOCAL channels (reference TFCluster.py:174-176)."""
        cluster = TFCluster.run(
            sc, fn_consume_all, {}, num_executors=2,
            input_mode=InputMode.SPARK, master_node=None,
            env=CPU_ENV, jax_distributed=False, reservation_timeout=180,
        )
        cluster.train(sc.parallelize(range(100), 2), num_epochs=1, feed_timeout=60)
        # sever the TCP route: port 1 refuses instantly on loopback
        for row in cluster.cluster_info:
            row["manager_addr"] = ("127.0.0.1", 1)
        cluster.shutdown(grace_secs=1, timeout=120)


class TestClusterTemplate:
    def test_role_order(self):
        t = TFCluster.build_cluster_template(5, num_ps=1, master_node="chief", eval_node=True)
        assert t[0] == ("ps", 0)
        assert t[1] == ("chief", 0)
        assert t[2] == ("evaluator", 0)
        assert t[3] == ("worker", 0)
        assert t[4] == ("worker", 1)

    def test_too_small(self):
        with pytest.raises(ValueError):
            TFCluster.build_cluster_template(1, num_ps=1, master_node=None)

    def test_bogus_master_node_rejected(self):
        with pytest.raises(ValueError, match="master_node"):
            TFCluster.build_cluster_template(2, master_node="None")
