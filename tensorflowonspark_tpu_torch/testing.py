"""Shared harness utilities for multi-process test worlds — the port of the
JAX package's ``testing.py``.

One place for the CPU-world bootstrap the tests use, so fixes to world
wiring (platform forcing, gloo selection, rendezvous addressing) cannot
drift between copies.
"""

import os


def join_cpu_world(pid, num_procs, coord_port):
    """Join a local ``torch.distributed`` world of ``num_procs`` processes
    on the CPU as rank ``pid``.

    Forces the CPU platform (``TOS_PLATFORM=cpu``, so ``ctx.device`` is the
    CPU and the world runs gloo), builds the reservation-shaped
    :class:`~tensorflowonspark_tpu_torch.TFSparkNode.TFNodeContext` for
    process ``pid`` with a loopback rendezvous, and joins the world. Returns
    the ctx; after this call ``torch.distributed.get_world_size() ==
    num_procs`` and ``ctx.mesh(...)`` builds meshes over it.
    """
    from tensorflowonspark_tpu_torch import util
    from tensorflowonspark_tpu_torch.TFSparkNode import TFNodeContext

    os.environ[util.ENV_PLATFORM] = "cpu"
    ctx = TFNodeContext(
        executor_id=pid,
        job_name="worker",
        task_index=pid,
        cluster_spec={"worker": ["localhost:{}".format(coord_port)] * num_procs},
        defaultFS="file://",
        working_dir=os.getcwd(),
        coordinator_address="127.0.0.1:{}".format(coord_port),
        num_processes=num_procs,
        process_id=pid,
    )
    ctx.initialize_distributed()
    return ctx
