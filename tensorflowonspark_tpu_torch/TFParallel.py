"""Run N independent single-node instances in parallel — no cluster, no
reservation server.

The port of the JAX package's ``TFParallel.py`` (the reference's Spark
barrier execution for parallel single-node inference, TFParallel.py:17-64):
each executor gets a synthetic
:class:`~tensorflowonspark_tpu_torch.TFSparkNode.TFNodeContext` (executor id from
the task's partition index, ``num_workers`` = parallelism, no manager/feed
plane) and runs the user function in a spawned child, pinned to its share
of the host's cards (``CUDA_VISIBLE_DEVICES``), so the executor never
touches CUDA and the cards free up when the task ends. The platform rides
the env lane as ``TOS_PLATFORM`` (``gpu`` by default, ``cpu`` hides every
card); the user function takes its device from ``ctx.device``.

A TPU chip takes one process, so the JAX version refuses more instances on
a host than chips. A CUDA card takes several: ``instances_per_card`` (1 by
default, the JAX version's rule) lets that many instances share each card,
instance ``i`` of a host on card ``i mod cards`` once they outnumber them.
"""

import logging
import os
import traceback

from tensorflowonspark_tpu_torch import TFSparkNode, gpu_info, util

logger = logging.getLogger(__name__)


class _ParallelTask:
    def __init__(self, fn, tf_args, num_executors, env=None, instances_per_card=1):
        self.fn = fn
        self.tf_args = tf_args
        self.num_executors = num_executors
        self.env = dict(env or {})
        self.instances_per_card = instances_per_card

    def __call__(self, iterator):
        executor_id = None
        for i in iterator:
            executor_id = i if not isinstance(i, (list, tuple)) else i[0]
        if executor_id is None:
            return []
        ctx = TFSparkNode.TFNodeContext(
            executor_id=executor_id,
            job_name="worker",
            task_index=executor_id,
            cluster_spec={"worker": ["localhost"] * self.num_executors},
            defaultFS="file://",
            working_dir=os.getcwd(),
        )

        # partition this host's cards across co-resident instances — the
        # reference placed workers on GPUs by local index (gpu_info.py:102);
        # without this, concurrent children would each take every card
        chip_ids = None
        n_chips = gpu_info.detect_local_chips()
        if n_chips and self.env.get(util.ENV_PLATFORM) != "cpu":
            local_rank, num_local = self._local_placement(executor_id)
            if num_local > n_chips * self.instances_per_card:
                raise RuntimeError(
                    "{} TFParallel instances on this host but only {} cards for {} instance(s) "
                    "each — reduce num_executors or instances per host".format(
                        num_local, n_chips, self.instances_per_card)
                )
            if num_local > n_chips:
                chip_ids = [local_rank % n_chips]
            else:
                per = n_chips // num_local
                start = local_rank * per
                chip_ids = list(range(start, start + per))

        def _entry():
            try:
                os.environ.update(self.env)
                # before anything touches CUDA in this (spawned) interpreter
                os.environ.update(
                    gpu_info.visibility_env(
                        chip_ids=chip_ids, platform=self.env.get(util.ENV_PLATFORM)
                    )
                )
                if self.env.get(util.ENV_PLATFORM):
                    util.force_platform(self.env[util.ENV_PLATFORM])
                self.fn(self.tf_args, ctx)
            except BaseException:
                logger.error("TFParallel fn failed:\n%s", traceback.format_exc())
                raise SystemExit(1)

        child = util.spawn_process(_entry, name="parallel-{}".format(executor_id))
        child.start()
        child.join()
        if child.exitcode != 0:
            raise RuntimeError(
                "TFParallel instance {} failed (exit {})".format(executor_id, child.exitcode)
            )
        return [executor_id]

    def _local_placement(self, executor_id):
        """(host-local rank, instances on this host). Real Spark barrier mode
        exposes co-located tasks via BarrierTaskContext (the reference's
        placement source, TFParallel.py:42-45); the local backend runs every
        instance on one host, so there the global id IS the local rank."""
        try:
            from pyspark import BarrierTaskContext

            ctx = BarrierTaskContext.get()
            infos = ctx.getTaskInfos()
            import socket

            me = socket.gethostname()
            local = [
                i for i, t in enumerate(infos)
                if t.address.split(":")[0] in (me, "localhost", "127.0.0.1")
            ]
            return local.index(ctx.partitionId()), max(len(local), 1)
        except Exception:
            return executor_id, self.num_executors


def run(sc, map_fn, tf_args, num_executors, env=None, instances_per_card=1):
    """Run ``map_fn(tf_args, ctx)`` as ``num_executors`` independent instances
    (reference TFParallel.run, TFParallel.py:17), at most
    ``instances_per_card`` of them on each card of a host. Returns the
    executor ids that completed."""
    if instances_per_card < 1:
        raise ValueError("instances_per_card must be at least 1, got {}".format(instances_per_card))
    kwargs = {"pin_to_executors": True} if getattr(sc, "PIN_SUPPORTED", False) else {}
    rdd = sc.parallelize(range(num_executors), num_executors, **kwargs)
    if hasattr(rdd, "barrier"):  # real Spark: barrier execution mode
        rdd = rdd.barrier()
    return rdd.mapPartitions(_ParallelTask(map_fn, tf_args, num_executors, env, instances_per_card)).collect()
