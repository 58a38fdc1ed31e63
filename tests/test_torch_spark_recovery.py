"""An executor lost mid-feed in InputMode.SPARK, recovered through
``TFCluster.run_with_recovery(feed_fn=...)``: ``cluster_check.py``'s
``mnist_spark_recover4`` leg on 4 gloo executors in one world at
``--size small --platform cpu``, the CPU twin of the four-card leg.

The leg is the JAX package's
``tests/test_recovery.py::test_spark_feed_killed_node_training_finishes_anyway``
on the port's ``mnist_spark.main_fun`` in one world: executor 2 is killed
once a checkpoint is committed, the reference's ``feed_fn`` re-feeds the
relaunched world, and every rank resumes from the same checkpoint."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_spark_fed_world_recovers_from_an_executor_lost_mid_feed(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "tensorflowonspark_tpu_torch.examples.cluster_check", "--platform", "cpu",
         "--size", "small", "--legs", "mnist_spark_recover4", "--work_dir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    (line,) = [json.loads(y) for y in proc.stdout.splitlines() if y.startswith('{"leg"')]
    assert line["leg"] == "mnist_spark_recover4" and line["failures"] == []
    # the reference's assertions: one relaunch, the feed loop once an attempt
    assert line["relaunches"] == 1 and line["feed_fn_calls"] == 2
    assert line["attempts"][0]["error"] and line["attempts"][1]["error"] is None
    # one loss blacklists no one: both lives hold all four executors
    lives = line["lives"]
    assert [life["world"] for life in lives] == [4, 4]
    assert [sorted(life["cards"]) for life in lives] == [["0", "1", "2", "3"]] * 2
    # the kill was armed at the first checkpoint and landed mid-feed: the
    # victim's first life ended before the step target
    steps = line["steps_per_rank"]  # steps_per_worker(2 x 2,400, 16, 4) = int(75 x 0.9)
    assert steps == 67 and line["kill_armed_at_checkpoint"] >= line["checkpoint_every"] == 24
    assert 0 < lives[0]["steps_reached"]["2"] < steps
    # each attempt fed its waves once its trainers had started
    assert all(a["start_wait_s"] is not None for a in line["attempts"])
    # every rank resumed from the newest checkpoint committed at the abort,
    # bitwise what rank 0 saved (the leg holds the digests), and trained to
    # the target with equal parameters
    newest = max(line["committed_at_abort"][0])
    assert lives[0]["restored"] == ["None"] and lives[1]["restored"] == ["ckpt_{}".format(newest)]
    assert lives[1]["restored_step"] == [newest] and newest >= 24
    assert lives[1]["final_step"] == [steps] * 4 and line["params_equal_on_every_rank"]
    assert all(e.startswith("ckpt_") for e in line["entries"])
    # each survivor's way out of the first life is recorded
    assert sorted(line["survivor_exits"]) == ["0", "1", "3"]
    # the readings are there, in order of the story
    assert 0 <= line["kill_to_driver_first_error_s"] <= line["kill_to_feed_fn_first_return_s"]
    assert line["abort_end_to_first_step_s"] > 0 and line["kill_to_last_step_s"] > line["abort_end_to_first_step_s"]
