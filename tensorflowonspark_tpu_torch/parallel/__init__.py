"""Parallelism core of the port: device meshes over ranks, collectives over
mesh axes, sharding rules, ring attention, pipeline schedules and the host
all-reduce group.

Where the JAX package expresses distribution as shardings over a named
``jax.sharding.Mesh`` and lets XLA insert the collectives, the port runs one
process a card: a mesh is a :class:`torch.distributed.device_mesh.DeviceMesh`
over ranks (:mod:`~tensorflowonspark_tpu_torch.parallel.mesh`), each
collective is an explicit ``torch.distributed`` call over an axis's group
(:mod:`~tensorflowonspark_tpu_torch.parallel.collectives`), ZeRO-3 is
the strategy's own step (:mod:`~tensorflowonspark_tpu_torch.parallel.
sharding`, ``SyncDataParallel(mesh, fsdp=True)``), the model axes split a
model built on the mesh (``transformer.create_model(mesh=...)``), and
ring attention passes K/V blocks around the ``sp`` group
(:mod:`~tensorflowonspark_tpu_torch.parallel.ring_attention`), GPipe passes
activations along the ``pp`` group and the host-driven 1F1B schedule runs
stages on threads of one process
(:mod:`~tensorflowonspark_tpu_torch.parallel.pipeline_parallel`), and
``HostAllReduceGroup`` reduces gradient buckets over host TCP for
``train.BucketedOverlap`` (:mod:`~tensorflowonspark_tpu_torch.parallel.
hostreduce`).

Canonical mesh axes (any subset may be present, always in this order):

=======  =====================================================================
``dp``   pure data parallelism (params replicated, batch sharded)
``fsdp`` data parallelism with fully-sharded params (batch AND params sharded)
``tp``   tensor (a.k.a. model) parallelism
``sp``   sequence/context parallelism — ring attention
``ep``   expert parallelism for MoE layers
``pp``   pipeline parallelism — GPipe over the axis (``pipeline_apply``)
=======  =====================================================================
"""

# Lazy re-exports (PEP 562): importing this package loads no torch.distributed
_EXPORTS = {
    "AXIS_ORDER": "mesh",
    "RankDevice": "mesh",
    "build_hybrid_mesh": "mesh",
    "build_mesh": "mesh",
    "local_mesh": "mesh",
    "mesh_shape": "mesh",
    "Sharding": "sharding",
    "batch_sharding": "sharding",
    "batch_spec": "sharding",
    "data_axes": "sharding",
    "fsdp_param_specs": "sharding",
    "overlay_fsdp_specs": "sharding",
    "replicated": "sharding",
    "shard_batch": "sharding",
    "shard_params": "sharding",
    "collectives": None,
    "mesh": None,
    "sharding": None,
    "plain_attention": "ring_attention",
    "ring_attention": "ring_attention",
    "ring_attention_sharded": "ring_attention",
    "ring_attention_local": "ring_attention",
    "HostAllReduceGroup": "hostreduce",
    "pipeline_apply": "pipeline_parallel",
    "pipeline_apply_local": "pipeline_parallel",
    "module_stage": "pipeline_parallel",
    "Pipeline1F1B": "pipeline_parallel",
    "schedule_1f1b": "pipeline_parallel",
    "stack_stage_params": "pipeline_parallel",
    "split_microbatches": "pipeline_parallel",
    "merge_microbatches": "pipeline_parallel",
    "hostreduce": None,
    "pipeline_parallel": None,
}


def __getattr__(name):
    import importlib

    if name not in _EXPORTS:
        raise AttributeError(name)
    submodule = _EXPORTS[name] or name
    mod = importlib.import_module("tensorflowonspark_tpu_torch.parallel." + submodule)
    return mod if _EXPORTS[name] is None else getattr(mod, name)


def __dir__():
    return sorted(_EXPORTS)
