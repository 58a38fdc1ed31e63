"""pyspark-surface compatibility branches, exercised with duck-typed fakes.

pyspark is not installed on the test hosts, so
the pyspark-shaped code paths — JVM Hadoop conf lookup, ``rdd.context``,
barrier-mode RDDs — are pinned by objects exposing exactly the attribute
surface pyspark exposes. ``run_tests.sh`` runs the suite against real Spark
when pyspark IS available (reference test/run_tests.sh:16-19).
"""

import os

from tensorflowonspark_tpu_torch import TFCluster, TFParallel


class _FakeHadoopConf:
    def get(self, key):
        assert key == "fs.defaultFS"
        return "hdfs://namenode:8020"


class _FakeJsc:
    def hadoopConfiguration(self):
        return _FakeHadoopConf()


class _FakePysparkContext:
    """What TFCluster sees of a real pyspark SparkContext: no defaultFS
    attribute, a _jsc JVM handle (reference TFCluster.py:271-274)."""

    _jsc = _FakeJsc()


def test_default_fs_from_jvm_hadoop_conf():
    assert TFCluster.resolve_default_fs(_FakePysparkContext()) == "hdfs://namenode:8020"


def test_default_fs_fallback_without_jvm():
    class _Bare:
        pass

    assert TFCluster.resolve_default_fs(_Bare()) == "file://"


def test_default_fs_local_backend_wins():
    class _Local:
        defaultFS = "file://"
        _jsc = _FakeJsc()  # must NOT be consulted

    assert TFCluster.resolve_default_fs(_Local()) == "file://"


class _FakeBarrierRDD:
    """pyspark RDD surface used by TFParallel.run: barrier() + mapPartitions
    + collect (reference TFParallel.py:63-64 nodeRDD.barrier().mapPartitions).
    Executes partitions inline, like a 1-task local Spark job."""

    def __init__(self, partitions):
        self._partitions = partitions
        self.barrier_called = False

    def barrier(self):
        self.barrier_called = True
        return self

    def mapPartitions(self, fn):
        self._fn = fn
        return self

    def collect(self):
        out = []
        for part in self._partitions:
            out.extend(self._fn(iter(part)))
        return out


class _FakeBarrierSC:
    """SparkContext surface TFParallel.run touches (no PIN_SUPPORTED attr on
    real pyspark, parallelize(range, n))."""

    def __init__(self):
        self.rdd = None

    def parallelize(self, data, num_slices):
        data = list(data)
        per = max(1, len(data) // num_slices)
        parts = [data[i : i + per] for i in range(0, len(data), per)]
        self.rdd = _FakeBarrierRDD(parts)
        return self.rdd


def _record_instance(args, ctx):
    with open(os.path.join(args["out_dir"], "instance-{}.txt".format(ctx.executor_id)), "w") as f:
        f.write("{} of {}".format(ctx.executor_id, ctx.num_workers))


def test_tfparallel_uses_barrier_rdd(tmp_path):
    """TFParallel over a pyspark-shaped barrier RDD runs every instance."""
    sc = _FakeBarrierSC()
    done = TFParallel.run(
        sc, _record_instance, {"out_dir": str(tmp_path)}, 2,
        env={"TOS_PLATFORM": "cpu"},
    )
    assert sc.rdd.barrier_called, "barrier execution mode was not requested"
    assert sorted(done) == [0, 1]
    assert sorted(os.listdir(str(tmp_path))) == ["instance-0.txt", "instance-1.txt"]
