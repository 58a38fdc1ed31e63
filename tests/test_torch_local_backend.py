"""Tests for the local multi-process execution backend."""

import os
import time

import pytest

from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext, TaskError


@pytest.fixture(scope="module")
def sc():
    ctx = LocalSparkContext(num_executors=2, task_timeout=60)
    yield ctx
    ctx.stop()


def _square_partition(it):
    return [x * x for x in it]


def test_parallelize_collect(sc):
    rdd = sc.parallelize(range(10), 4)
    assert rdd.getNumPartitions() == 4
    assert sorted(rdd.collect()) == list(range(10))


def test_map_partitions_and_sum(sc):
    rdd = sc.parallelize(range(5), 2).mapPartitions(_square_partition)
    assert rdd.sum() == sum(x * x for x in range(5))


def test_map_and_count(sc):
    rdd = sc.parallelize(range(7), 2).map(lambda x: x + 1)
    assert rdd.count() == 7
    assert sorted(rdd.collect()) == list(range(1, 8))


def test_union_epochs(sc):
    rdd = sc.parallelize(range(3), 1)
    unioned = sc.union([rdd] * 3)
    assert unioned.getNumPartitions() == 3
    assert sorted(unioned.collect()) == sorted(list(range(3)) * 3)


def test_union_of_transformed_rdds(sc):
    """The epochs-via-union trick must work on an already-mapped RDD
    (TFCluster.train unions a user RDD that typically has map chains)."""
    rdd = sc.parallelize(range(3), 1).map(lambda x: x * 10)
    other = sc.parallelize(range(2), 1).mapPartitions(_square_partition)
    unioned = sc.union([rdd, rdd, other])
    assert sorted(unioned.collect()) == sorted([0, 10, 20] * 2 + [0, 1])


def test_error_propagates_with_remote_traceback(sc):
    def boom(it):
        raise ValueError("deliberate failure in task")

    with pytest.raises(TaskError, match="deliberate failure"):
        sc.parallelize(range(4), 2).mapPartitions(boom).collect()


def test_pinned_tasks_run_on_distinct_executors(sc):
    def report_executor(it):
        list(it)
        return [int(os.environ["TOS_LOCAL_EXECUTOR_ID"])]

    rdd = sc.parallelize(range(2), 2, pin_to_executors=True)
    eids = rdd.mapPartitions(report_executor).collect()
    assert sorted(eids) == [0, 1]


def test_executor_state_persists_across_tasks(sc):
    """One task writes a file in the executor CWD; a pinned follow-up task on
    the same executor sees it (the SPARK_REUSE_WORKER analogue)."""

    def write_marker(it):
        list(it)
        with open("marker.txt", "w") as f:
            f.write(os.environ["TOS_LOCAL_EXECUTOR_ID"])
        return [1]

    def read_marker(it):
        list(it)
        return [os.path.exists("marker.txt")]

    sc.parallelize(range(2), 2, pin_to_executors=True).mapPartitions(write_marker).collect()
    got = sc.parallelize(range(2), 2, pin_to_executors=True).mapPartitions(read_marker).collect()
    assert got == [True, True]


def test_concurrent_jobs(sc):
    """A blocking job on pinned slots must not starve a second job — executors
    pull shared-queue tasks as they free up."""
    import threading

    def slowish(it):
        time.sleep(0.3)
        return [sum(it)]

    results = {}

    def run(name, pin):
        rdd = sc.parallelize(range(4), 2, pin_to_executors=pin)
        results[name] = rdd.mapPartitions(slowish).sum()

    t1 = threading.Thread(target=run, args=("a", True))
    t2 = threading.Thread(target=run, args=("b", False))
    t1.start(), t2.start()
    t1.join(30), t2.join(30)
    assert results["a"] == results["b"] == sum(range(4))
