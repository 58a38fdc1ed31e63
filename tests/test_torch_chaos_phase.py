"""``chip_smoke.py``'s ``chaos_cluster`` phase on the CPU lane: the JAX
package's cluster chaos (``tests/test_chaos_cluster.py``'s plan and
``tests/test_ckpt_chaos.py``'s torn commit) through the port's MNIST example
fed from Spark, as ``examples/cluster_check.py``'s ``mnist_spark_story`` runs
it on the card."""

from tensorflowonspark_tpu_torch.examples import cluster_check


def test_chaos_cluster_stories_on_the_cpu(tmp_path):
    """Both legs in one trainer life on one executor: a commit torn in the
    trainer child and the driver's resume from the good checkpoint, bitwise
    step 1's; then the trainer fed from Spark in uneven partitions under
    the cluster chaos plan, every fault counted."""
    story = cluster_check.mnist_spark_story(str(tmp_path), "chaos_cluster", 1, 600, 1, 16, "cpu", tear=True)
    assert cluster_check.mnist_story_failures("chaos_cluster", story, 1, 16, "cpu") == []
    # int(600 / 16 x 0.9) = 33 steps; the partitions are 4:3:2:1:4:3:2:1 of 600 rows
    assert story["steps"] == 33 and [s["steps"] for s in story["spans"]] == [33]
    assert [len(p) for p in story["parts"]] == [120, 90, 60, 30] * 2 and story["pins"] == [0] * 8
    tear = story["tear"]
    assert cluster_check.tear_failures("chaos_cluster", tear, "cpu") == []
    assert tear["entries"] == ["ckpt_1", "tmp.ckpt_2"] and tear["restored"] == "ckpt_1" and tear["tears"] == 1
