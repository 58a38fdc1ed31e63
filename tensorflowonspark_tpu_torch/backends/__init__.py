"""Execution backends.

The framework's driver API is written against the small slice of the Spark
surface it actually uses (``parallelize``/``union``/``foreachPartition``/
``mapPartitions``/``collect``). Two backends provide it:

* :mod:`~tensorflowonspark_tpu_torch.backends.local` — a multi-process local
  "standalone cluster": N long-lived executor processes with one task slot
  each, the same process topology the reference's test harness built with a
  2-worker Spark Standalone cluster (reference test/run_tests.sh:16-19,
  SURVEY.md §4). No pyspark required.
* a real ``pyspark.SparkContext`` — used as-is when available; the framework
  only calls public RDD methods, so any genuine Spark cluster works.
"""


def is_spark_context(sc):
    """True if ``sc`` is a real pyspark SparkContext (duck-typed; pyspark may
    not be installed at all)."""
    mod = type(sc).__module__ or ""
    return mod.startswith("pyspark")


def create_dataframe(sc, rows, columns, num_partitions=None):
    """Build a DataFrame on either backend: the local backend's
    ``createDataFrame`` (LocalDataFrame), or — on a real pyspark
    SparkContext, which has no such method — the session's
    ``createDataFrame`` over a parallelized RDD."""
    if is_spark_context(sc):
        from pyspark.sql import SparkSession

        rdd = (
            sc.parallelize(rows, num_partitions)
            if num_partitions else sc.parallelize(rows)
        )
        return SparkSession(sc).createDataFrame(rdd, list(columns))
    return sc.createDataFrame(rows, list(columns), num_partitions)


def get_spark_context(app_name, num_executors=None, task_timeout=600, sc=None,
                      local_default=1, min_local_executors=1):
    """The examples' context factory: a REAL ``pyspark.SparkContext`` when
    the program is running under Spark, the bundled local backend otherwise.
    Returns ``(sc, num_executors, owned)`` — ``owned`` False when the
    context came from the caller or an already-active pyspark context was
    reused (don't stop what you did not create).

    Pass ``sc`` to inject an existing context of either backend (tests, or
    apps that built their own): it is returned as-is with ``owned=False``.

    "Running under Spark" means pyspark is importable AND one of: an active
    SparkContext already exists (spark-submit re-running the driver),
    ``MASTER``/``SPARK_MASTER`` is set, spark-submit's launch scripts ran
    (``SPARK_ENV_LOADED``), or ``TOS_SPARK=1`` forces it. ``TOS_SPARK=0``
    forces the local backend even with pyspark installed.

    ``num_executors`` is the user's EXPLICIT request (examples pass their
    ``--cluster_size`` flag with ``default=None``) and always wins — with a
    WARNING when it disagrees with the submitted conf. Without it, a real
    context sizes from ``spark.executor.instances`` (the reference
    examples' own rule, e.g. reference examples/mnist/keras/
    mnist_spark.py:29-31), else ``defaultParallelism`` (standalone
    clusters don't set ``instances``), else ``local_default``; the local
    backend uses ``local_default``. The same resolution applies to an
    injected ``sc``.

    A local pool this creates holds at least ``min_local_executors``
    executors, more than the cluster size where a later job needs them (a
    TFParallel leg of more instances than the cluster has nodes pins one to
    each executor); the returned count stays the cluster size.
    """
    import logging
    import os

    logger = logging.getLogger(__name__)
    if sc is not None:
        return sc, _resolve_executor_count(sc, num_executors, local_default, logger), False
    forced = os.environ.get("TOS_SPARK")
    use_spark = False
    if forced != "0":
        try:
            import pyspark

            active = pyspark.SparkContext._active_spark_context is not None
            use_spark = (
                forced == "1"
                or active
                or bool(os.environ.get("MASTER") or os.environ.get("SPARK_MASTER"))
                or bool(os.environ.get("SPARK_ENV_LOADED"))
            )
        except ImportError:
            if forced == "1":
                raise
    if use_spark:
        import pyspark

        existing = pyspark.SparkContext._active_spark_context
        owned = existing is None
        conf = pyspark.SparkConf().setAppName(app_name)
        master = os.environ.get("MASTER") or os.environ.get("SPARK_MASTER")
        if owned and master and not conf.contains("spark.master"):
            conf.setMaster(master)
        sc = existing if existing is not None else pyspark.SparkContext(conf=conf)
        resolved = _resolve_executor_count(sc, num_executors, local_default, logger)
        logger.info(
            "using real pyspark SparkContext (master=%s, %d executors)",
            sc.master, resolved,
        )
        return sc, resolved, owned

    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext

    n = num_executors or local_default
    return LocalSparkContext(num_executors=max(n, min_local_executors), task_timeout=task_timeout), n, True


def _resolve_executor_count(sc, num_executors, local_default, logger):
    """get_spark_context's sizing rule, shared by the active-context and
    injected-``sc`` paths: explicit request > submitted conf >
    defaultParallelism > local_default."""
    instances = None
    if is_spark_context(sc):
        raw = sc.getConf().get("spark.executor.instances")
        instances = int(raw) if raw else None
    if num_executors:
        if instances and instances != num_executors:
            logger.warning(
                "explicit cluster size %d overrides spark.executor.instances=%d",
                num_executors, instances,
            )
        return num_executors
    if instances:
        return instances
    if is_spark_context(sc):
        return sc.defaultParallelism or local_default
    return local_default
