"""The port's MNIST examples through its ``TFCluster`` on the CPU, at small
sizes (hidden 32, a few hundred examples).

* ``mnist_spark`` (InputMode.SPARK) on one executor and on two; with two, a
  gloo torch.distributed world whose ranks end with bitwise-equal
  parameters.
* Feed counts: the steps trained and rows consumed per node, and the feed
  plane's row and chunk counters, equal those of the JAX package's
  ``examples/mnist/mnist_spark.py`` run once here on the same data,
  partitions and epochs.
* ``--model_dir``: a second run resumes from the first's checkpoint;
  ``--auto_recover 1`` runs through ``run_with_recovery`` (0 relaunches on a
  healthy run).
* The other examples, as ``tests/test_examples.py`` runs the JAX ones:
  streaming waves, ``mnist_tf`` over ``mnist_data_setup``'s TFRecords, and
  ``mnist_pipeline`` (fit → export → transform) then ``mnist_inference``
  (TFParallel) over its bundle.
* Each example's ``main`` fails without a CUDA device unless the caller
  passes ``--platform cpu``: it never falls back to the CPU.
"""

import argparse
import os
import sys

import numpy as np
import pytest

from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
from tensorflowonspark_tpu_torch.examples.mnist import (
    mnist_data_setup, mnist_inference, mnist_pipeline, mnist_spark, mnist_spark_streaming, mnist_tf,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the feed-count case, shared by the port's run and the JAX package's
FEED = dict(num_examples=640, batch_size=32, num_partitions=8, epochs=1)
TINY = ["--platform", "cpu", "--hidden", "32", "--log_steps", "5"]


def _argv(**kw):
    return [a for k, v in kw.items() for a in ("--" + k, str(v))]


def _spans(metrics, name):
    return [e for e in metrics["events"] if e.get("span") == name]


def _counter(metrics, name):
    return metrics["counters"].get(name, {}).get("value", 0)


def jax_counting_main_fun(args, ctx):
    """The JAX package's ``examples/mnist/mnist_spark.py`` ``main_fun``, its
    feed wrapped to count the batches it trains on (one step each) and
    their rows; writes ``{"steps", "rows"}`` to ``args.counts``."""
    import json

    sys.path.insert(0, os.path.join(args.repo, "examples", "mnist"))
    import mnist_spark as jax_mnist_spark

    counts = {"steps": 0, "rows": 0}
    get_data_feed = ctx.get_data_feed

    def counting_feed(*a, **kw):
        feed = get_data_feed(*a, **kw)
        next_batch = feed.next_batch

        def counted(*b, **bkw):
            batch = next_batch(*b, **bkw)
            if batch:
                counts["steps"] += 1
                counts["rows"] += len(batch)
            return batch

        feed.next_batch = counted
        return feed

    ctx.get_data_feed = counting_feed
    jax_mnist_spark.main_fun(args, ctx)
    with open(args.counts, "w") as f:
        json.dump(counts, f)


def _jax_feed_counts(tmp_path):
    """One run of the JAX package's example on the CPU: its trainer's
    counts and its cluster's feed counters."""
    import json

    from tensorflowonspark_tpu import TFCluster as JaxTFCluster
    from tensorflowonspark_tpu.backends.local import LocalSparkContext as JaxLocalSparkContext

    images, labels = mnist_data_setup.synthetic_mnist(FEED["num_examples"])
    data = mnist_data_setup.to_rows(images, labels)
    args = argparse.Namespace(learning_rate=1e-3, model_dir=None, export_dir=None, checkpoint_steps=100,
                              repo=REPO, counts=str(tmp_path / "jax_counts.json"), **FEED)
    sc = JaxLocalSparkContext(num_executors=1, task_timeout=300)
    try:
        cluster = JaxTFCluster.run(sc, jax_counting_main_fun, args, 1, input_mode=JaxTFCluster.InputMode.SPARK,
                                   master_node="chief", env={"JAX_PLATFORMS": "cpu"})
        cluster.train(sc.parallelize(data, FEED["num_partitions"]), num_epochs=FEED["epochs"])
        metrics = cluster.metrics(include_driver=False)
        cluster.shutdown(grace_secs=5)
    finally:
        sc.stop()
    with open(args.counts) as f:
        counts = json.load(f)
    return dict(counts, feed_rows=_counter(metrics, "feed_rows_total"),
                feed_chunks=_counter(metrics, "feed_chunks_total"))


def test_mnist_spark_one_executor_trains_exports_and_matches_the_jax_feed_counts(tmp_path):
    export_dir = str(tmp_path / "bundle")
    out = mnist_spark.main(TINY + _argv(cluster_size=1, export_dir=export_dir, **FEED))
    metrics = out["metrics"]
    (span,) = _spans(metrics, "mnist_train")
    port = {"steps": _counter(metrics, "train_steps_total"), "rows": _counter(metrics, "train_rows_total"),
            "feed_rows": _counter(metrics, "feed_rows_total"),
            "feed_chunks": _counter(metrics, "feed_chunks_total")}
    # the 90% cap: int(640 / 32 * 0.9) = 18 steps of full batches
    assert port["steps"] == span["steps"] == 18 and port["rows"] == span["rows"] == 18 * 32
    assert port["feed_rows"] == 640 and out["train_s"] > 0
    assert np.isfinite(span["first_loss"]) and span["last_loss"] < span["first_loss"]
    assert span["device"] == "cpu" and span["images_per_sec"] > 0
    # the MNIST path runs none of the port's kernels
    assert {k: v["value"] for k, v in metrics["counters"].items() if k.endswith("_launches_total")} == {
        name + "_launches_total": 0 for name in (
            "bn_stats", "bn_normalize", "bn_bwd_reduce", "bn_bwd_dx", "bn_finish",
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    assert sorted(os.listdir(export_dir)) == ["predict_builder.pkl", "weights.npz"]
    # the reference: the JAX package's example on the same data, partitions, epochs
    assert port == _jax_feed_counts(tmp_path)


def test_mnist_spark_two_executors_keep_bitwise_equal_replicas():
    """Two trainers in a gloo world: each trains on its own partitions'
    rows, gradients and metrics are averaged, and both end with the same
    parameter bytes."""
    sc = LocalSparkContext(num_executors=2, task_timeout=300)
    try:
        out = mnist_spark.main(TINY + _argv(cluster_size=2, num_examples=512, batch_size=32, num_partitions=8,
                                            epochs=2), sc=sc)
    finally:
        sc.stop()
    spans = _spans(out["metrics"], "mnist_train")
    assert sorted(s["rank"] for s in spans) == [0, 1]
    # int(2 * 512 / (32 * 2) * 0.9) = 14 steps a rank
    assert [s["steps"] for s in spans] == [14, 14]
    assert spans[0]["params_sha256"] == spans[1]["params_sha256"]
    assert spans[0]["last_loss"] == spans[1]["last_loss"]  # the global batch's loss on both
    assert _counter(out["metrics"], "feed_rows_total") >= 2 * 14 * 32


def test_mnist_spark_resumes_from_model_dir_and_auto_recover(tmp_path):
    from tensorflowonspark_tpu_torch.train import checkpoint

    model_dir = str(tmp_path / "model")
    args = TINY + _argv(cluster_size=1, num_examples=256, batch_size=32, num_partitions=4, checkpoint_steps=2,
                        model_dir=model_dir)
    first = mnist_spark.main(args + ["--epochs", "1"])
    (span,) = _spans(first["metrics"], "mnist_train")
    assert span["steps"] == 7 and sorted(os.listdir(model_dir)) == ["ckpt_2", "ckpt_4", "ckpt_6"]
    second = mnist_spark.main(args + ["--epochs", "2"])
    (restore,) = _spans(second["metrics"], "ckpt_restore")
    (span,) = _spans(second["metrics"], "mnist_train")
    assert restore["path"].endswith("ckpt_6") and restore["step"] == 6
    # int(2 * 256 / 32 * 0.9) = 14 steps in all, 8 of them in this run
    assert span["start_step"] == 6 and span["steps"] == 8
    assert checkpoint.restore_checkpoint(os.path.join(model_dir, "ckpt_14"))["step"] == 14
    # --auto_recover: the same feed through run_with_recovery's feed_fn
    recovered = mnist_spark.main(args + ["--epochs", "3", "--auto_recover", "1"])
    assert recovered["relaunches"] == 0 and "ckpt_20" in os.listdir(model_dir)
    with pytest.raises(SystemExit):
        mnist_spark.main(TINY + ["--auto_recover", "1"])


def test_mnist_streaming_trains_on_waves(capfd):
    mnist_spark_streaming.main(TINY + _argv(cluster_size=1, num_waves=3, wave_rows=64, batch_size=32,
                                            batch_interval=0.2))
    assert "streaming training complete" in capfd.readouterr().out


def test_streaming_context_stop_drains_and_never_starves():
    """``stop()`` waits for a micro-batch in flight, and returns while the
    ticker idles on an empty queue: no lock is held across the ticker's
    wait, which starved ``stop()`` (the streaming example hung at shutdown
    in 2 of 5 runs)."""
    import time

    from tensorflowonspark_tpu_torch.backends.local import LocalStreamingContext

    handled = []
    ssc = LocalStreamingContext(None, batch_interval=0.01)
    ssc.queueStream().foreachRDD(lambda rdd: (time.sleep(0.3), handled.append(rdd)))
    ssc.start()
    ssc.feed("wave-1")
    time.sleep(0.05)  # dequeued, feeding
    t0 = time.perf_counter()
    ssc.stop()
    assert handled == ["wave-1"] and time.perf_counter() - t0 < 5
    for _ in range(20):  # an idle ticker many times over
        idle = LocalStreamingContext(None, batch_interval=0.001)
        idle.start()
        time.sleep(0.01)
        t0 = time.perf_counter()
        idle.stop()
        assert time.perf_counter() - t0 < 5


def test_mnist_data_setup_and_tf_mode(tmp_path, capfd):
    data = str(tmp_path / "tfr")
    mnist_data_setup.main(["--output", data, "--num_examples", "256", "--num_partitions", "2"])
    mnist_tf.main(TINY[:4] + _argv(data_dir=data, cluster_size=1, epochs=1, batch_size=32))
    out = capfd.readouterr().out
    assert "wrote 256 examples" in out and "training complete" in out and "final: loss" in out


def test_mnist_pipeline_then_parallel_inference(tmp_path):
    """The Spark-ML pipeline (fit → bundle → transform) equals the bundle's
    predict_fn called directly, and TFParallel's part files over the same
    bundle agree with a direct predict of their rows."""
    from tensorflowonspark_tpu_torch.train import export

    export_dir = str(tmp_path / "bundle")
    preds, labels, devices = mnist_pipeline.main(
        TINY[:4] + _argv(cluster_size=1, epochs=1, num_examples=256, batch_size=32, num_test=48,
                         export_dir=export_dir))
    assert len(preds) == 48 and set(devices) == {"cpu"}
    predict_fn, params, model_state = export.load_model(export_dir, device="cpu")
    images, _ = mnist_data_setup.synthetic_mnist(256)
    direct = predict_fn(params, model_state, {"image": images[:48].reshape(48, -1)})["prediction"]
    assert preds == direct.tolist()

    output = str(tmp_path / "preds")
    done = mnist_inference.main(["--platform", "cpu"] + _argv(cluster_size=2, num_examples=96, batch_size=32,
                                                               export_dir=export_dir, output=output))
    assert sorted(done) == [0, 1] and sorted(os.listdir(output)) == ["part-00000", "part-00001"]
    pairs = mnist_inference.read_parts(output)
    test_images, test_labels = mnist_data_setup.synthetic_mnist(96, seed=99)
    want = predict_fn(params, model_state, {"image": test_images.reshape(96, -1)})["prediction"]
    assert sorted(pairs) == sorted(zip(test_labels.tolist(), want.tolist()))


@pytest.mark.parametrize("example", ["spark", "streaming", "tf", "pipeline", "inference"])
def test_every_main_refuses_to_run_without_cuda(example, tmp_path):
    """``--platform`` defaults to ``gpu``: without a CUDA device the trainer
    (or the inference instance) raises instead of taking the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    if example == "spark":
        run = lambda: mnist_spark.main(_argv(cluster_size=1, num_examples=64, epochs=1))  # noqa: E731
    elif example == "streaming":
        run = lambda: mnist_spark_streaming.main(_argv(cluster_size=1, num_waves=1, wave_rows=32,  # noqa: E731
                                                       batch_interval=0.1))
    elif example == "tf":
        data = str(tmp_path / "tfr")
        mnist_data_setup.main(["--output", data, "--num_examples", "32", "--num_partitions", "1"])
        run = lambda: mnist_tf.main(_argv(data_dir=data, cluster_size=1, epochs=1))  # noqa: E731
    elif example == "pipeline":
        run = lambda: mnist_pipeline.main(_argv(cluster_size=1, epochs=1, num_examples=64,  # noqa: E731
                                                export_dir=str(tmp_path / "b")))
    else:
        from tensorflowonspark_tpu_torch.models import mnist
        from tensorflowonspark_tpu_torch.train import export

        export.export_model(str(tmp_path / "b"), mnist.bundle_builder("mlp", hidden=32),
                            dict(mnist.MnistMLP(hidden=32).named_parameters()))
        run = lambda: mnist_inference.main(_argv(cluster_size=1, num_examples=32,  # noqa: E731
                                                 export_dir=str(tmp_path / "b"), output=str(tmp_path / "o")))
    with pytest.raises(RuntimeError, match="no CUDA device|failed"):
        run()
