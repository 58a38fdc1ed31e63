"""get_spark_context / create_dataframe: the examples' backend selection.

The real-pyspark legs (reuse of an active SparkContext, executor-count
resolution from the submitted conf, an example end-to-end on local-cluster)
live in tests/test_real_pyspark.py; here the local side and the forcing
knobs are pinned."""

import importlib.util

import pytest

from tensorflowonspark_tpu_torch.backends import create_dataframe, get_spark_context
from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext

HAVE_PYSPARK = importlib.util.find_spec("pyspark") is not None


@pytest.mark.skipif(HAVE_PYSPARK, reason="selection with pyspark present is CI-leg territory")
def test_local_fallback_without_pyspark(monkeypatch):
    monkeypatch.delenv("TOS_SPARK", raising=False)
    monkeypatch.delenv("MASTER", raising=False)
    sc, n, owned = get_spark_context("ctx-test", 3)
    try:
        assert isinstance(sc, LocalSparkContext)
        assert n == 3 and owned
    finally:
        sc.stop()


def test_tos_spark_0_forces_local(monkeypatch):
    monkeypatch.setenv("TOS_SPARK", "0")
    monkeypatch.setenv("MASTER", "local-cluster[2,1,1024]")  # must be ignored
    sc, n, owned = get_spark_context("ctx-test", 2)
    try:
        assert isinstance(sc, LocalSparkContext)
        assert n == 2 and owned
    finally:
        sc.stop()


@pytest.mark.skipif(HAVE_PYSPARK, reason="with pyspark installed TOS_SPARK=1 is legitimate")
def test_tos_spark_1_without_pyspark_raises(monkeypatch):
    monkeypatch.setenv("TOS_SPARK", "1")
    with pytest.raises(ImportError):
        get_spark_context("ctx-test", 1)


def test_local_default_used_when_no_explicit_size(monkeypatch):
    """Examples pass --cluster_size default=None; locally the per-example
    local_default applies (under Spark the cluster's conf/parallelism
    would — pinned in the CI real-pyspark leg)."""
    monkeypatch.setenv("TOS_SPARK", "0")
    sc, n, owned = get_spark_context("ctx-test", None, local_default=2)
    try:
        assert n == 2 and owned
    finally:
        sc.stop()


def test_create_dataframe_local_backend():
    sc = LocalSparkContext(num_executors=1)
    try:
        df = create_dataframe(sc, [(1, 2.0), (3, 4.0)], ["a", "b"], 1)
        assert df.columns == ["a", "b"]
        assert sorted(row[0] for row in df.collect()) == [1, 3]
    finally:
        sc.stop()


def test_injected_local_context_uses_local_default():
    sc = LocalSparkContext(num_executors=2)
    try:
        got, n, owned = get_spark_context("ctx-test", None, sc=sc, local_default=2)
        assert got is sc and n == 2 and not owned
        got, n, owned = get_spark_context("ctx-test", 5, sc=sc)
        assert n == 5 and not owned  # explicit request always wins
    finally:
        sc.stop()
