"""The port's segmentation and estimator examples and ``stop_cluster``
through its ``TFCluster`` on the CPU, at small sizes — the cases of
``tests/test_examples.py`` on the port:

* ``segmentation_spark`` as a program (``--cluster_size 1``): trains,
  exports, and its inference leg writes the instance's result;
* its inference leg with two TFParallel instances, each instance's masks
  equal to a direct predict of the bundle on its shard;
* ``mnist_estimator`` with ``--cluster_size 2`` (the chief and the
  evaluator): the evaluator's last record comes from the last checkpoint
  and equals a direct evaluation of it;
* ``stop_cluster`` against a live cluster sets ``cluster.stop_requested``.
"""

import math
import os
import subprocess
import sys

import numpy as np

from tensorflowonspark_tpu_torch import TFCluster, util
from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
from tensorflowonspark_tpu_torch.examples.mnist import mnist_estimator
from tensorflowonspark_tpu_torch.examples.segmentation import segmentation_spark
from tensorflowonspark_tpu_torch.examples.utils import stop_cluster
from tensorflowonspark_tpu_torch.train import checkpoint, export

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG = ["--platform", "cpu", "--train_steps", "4", "--image_size", "32", "--depth", "2",
       "--base_filters", "8", "--batch_size", "4"]


def test_segmentation_spark(tmp_path):
    export_dir = str(tmp_path / "seg_bundle")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "tensorflowonspark_tpu_torch.examples.segmentation.segmentation_spark",
         "--cluster_size", "1", "--export_dir", export_dir, "--inference_count", "8"] + SEG,
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "segmentation training complete" in out.stdout
    # multi-worker (independent instance) inference over the exported bundle
    assert "segmentation inference complete" in out.stdout
    with open(os.path.join(export_dir, "inference-0.txt")) as f:
        count, height, acc = f.read().split()
    assert (count, height) == ("8", "32") and 0.0 <= float(acc) <= 1.0


def test_two_instance_inference_equals_a_direct_predict(tmp_path):
    """Training on one executor, then two TFParallel instances: each
    instance's masks equal, pixel for pixel, the bundle's ``predict_fn``
    run here on the same shard; the trainer reports its steps, falling
    loss and no kernel launches."""
    export_dir = str(tmp_path / "bundle")
    argv = ["--cluster_size", "1", "--export_dir", export_dir, "--inference_count", "6",
            "--inference_instances", "2", "--log_steps", "1"] + SEG
    sc = LocalSparkContext(num_executors=2)
    try:
        result = segmentation_spark.main(argv, sc=sc)
    finally:
        sc.stop()
    assert sorted(result["inference"]) == [0, 1]
    events = result["metrics"]["events"]
    steps = sorted((e for e in events if e.get("span") == "train_step"), key=lambda e: e["step"])
    assert [e["step"] for e in steps] == [1, 2, 3, 4]
    assert all(math.isfinite(e["loss"]) for e in steps)
    (summary,) = [e for e in events if e.get("span") == "seg_train"]
    assert summary["device"] == "cpu" and summary["peak_memory_bytes"] is None
    counters = result["metrics"]["counters"]
    assert all(v["value"] == 0 for k, v in counters.items() if k.endswith("_launches_total"))

    args = segmentation_spark.build_parser().parse_args(argv)
    predict_fn, params, model_state = export.load_model(export_dir, device="cpu")
    for i in range(2):
        images, masks = segmentation_spark.inference_shard(args, i, 2)
        want = predict_fn(params, model_state, {"image": images})["mask"]
        with np.load(os.path.join(export_dir, "inference-{}.npz".format(i))) as got:
            assert np.array_equal(got["mask"], want) and list(got["device"]) == ["cpu"] * len(images)
        with open(os.path.join(export_dir, "inference-{}.txt".format(i))) as f:
            assert f.read().split()[:2] == [str(len(images)), "32"]


def test_mnist_estimator_with_evaluator(tmp_path):
    model_dir = str(tmp_path / "est")
    records = mnist_estimator.main([
        "--cluster_size", "2", "--epochs", "1", "--num_examples", "512", "--batch_size", "64",
        "--checkpoint_steps", "4", "--model_dir", model_dir, "--platform", "cpu"])
    assert os.path.exists(os.path.join(model_dir, mnist_estimator.RESULTS))
    assert records and all(r["device"] == "cpu" for r in records)
    latest = checkpoint.latest_checkpoint(model_dir)
    # 90% of 512 / 64 rows: 7 steps, checkpoints at 4 and the final 7
    assert os.path.basename(latest) == "ckpt_7" == records[-1]["checkpoint"]
    assert records[-1]["accuracy"] == mnist_estimator.evaluate(latest, "cpu", 256)


def fn_wait_for_stop(args, ctx):
    feed = ctx.get_data_feed(train_mode=True)
    while not feed.should_stop():
        if not feed.next_batch(8):
            break


def test_stop_cluster_requests_stop_of_a_live_cluster(capsys):
    sc = LocalSparkContext(num_executors=1)
    try:
        cluster = TFCluster.run(sc, fn_wait_for_stop, {}, 1, input_mode=TFCluster.InputMode.SPARK,
                                env={util.ENV_PLATFORM: "cpu"}, reservation_timeout=120)
        try:
            assert not cluster.stop_requested
            host, port = cluster.cluster_meta["server_addr"]
            stop_cluster.main([host, str(port)])
            assert cluster.stop_requested
            assert "requested stop of cluster at {}:{}".format(host, port) in capsys.readouterr().out
        finally:
            cluster.shutdown(grace_secs=1, timeout=120)
    finally:
        sc.stop()
