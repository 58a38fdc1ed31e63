"""Async checkpointing: snapshot-to-host, background commit, manifest.

The SPARK-mode recovery story rests on checkpoints (``run_with_recovery``
resumes a killed worker from its newest one), but the blocking save path
taxes every save against step throughput. This package makes frequent
checkpointing nearly free:

* :mod:`~tensorflowonspark_tpu_torch.ckpt.snapshot` — snapshot-to-host into
  pooled pinned double buffers, ordered on the training stream (the
  training thread pays only for queueing the device-to-host copies);
* :mod:`~tensorflowonspark_tpu_torch.ckpt.engine` — a single background
  writer (bounded hand-off, newest snapshot supersedes a queued one)
  performing the ``torch.save`` write and the atomic manifest-committed
  publish;
* :mod:`~tensorflowonspark_tpu_torch.ckpt.manifest` — ``MANIFEST.json``
  written last + rename-published, so ``restore_latest`` cheap-verifies
  integrity instead of attempting restores.

* :mod:`~tensorflowonspark_tpu_torch.ckpt.reshard` — ``reshard_restore``:
  a checkpoint (always full tensors) restored onto another mesh, each rank
  keeping its block under the new strategy's placement.

Lazy re-exports (PEP 562) keep ``import tensorflowonspark_tpu_torch.ckpt``
light — torch loads only when a snapshot or restore actually runs.
"""

_EXPORTS = {
    "AsyncCheckpointEngine": "engine",
    "in_flight_paths": "engine",
    "drain_all": "engine",
    "busy_descriptions": "engine",
    "TMP_MARKER": "engine",
    "SnapshotBuffers": "snapshot",
    "HostSnapshot": "snapshot",
    "snapshot_to_host": "snapshot",
    "MANIFEST_NAME": "manifest",
    "write_manifest": "manifest",
    "read_manifest": "manifest",
    "verify": "manifest",
    "reshard_restore": "reshard",
    "state_shardings": "reshard",
    "engine": None,
    "snapshot": None,
    "manifest": None,
    "reshard": None,
}


def __getattr__(name):
    import importlib

    if name not in _EXPORTS:
        raise AttributeError(name)
    submodule = _EXPORTS[name] or name
    mod = importlib.import_module("tensorflowonspark_tpu_torch.ckpt." + submodule)
    return mod if _EXPORTS[name] is None else getattr(mod, name)


def __dir__():
    return sorted(_EXPORTS)
