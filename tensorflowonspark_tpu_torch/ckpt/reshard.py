"""Resharded restore: map a checkpoint onto a *different* mesh — the port of
the JAX package's ``ckpt/reshard.py``.

The elastic-recovery case: a cluster checkpoints on a 1×N mesh, a worker
dies, and ``run_with_recovery`` relaunches with a different rank count —
the restored tensors must land on the new mesh under the new placement. A
checkpoint of the port holds full tensors whatever the placement it was
saved from (``train/checkpoint.py`` gathers a sharded state's shards), so
the restore is two-phase:

1. ``torch.load`` the checkpoint into full host tensors (mesh-free), then
2. keep this rank's block of each under the placement the **new** strategy
   derives for it (parameters and their optimizer slots via
   ``param_shardings``, step and model state replicated — exactly the
   placement ``create_state`` produces).

Host memory bounds this (phase 1 materializes full tensors on the host of
every rank), which is the right trade for the recovery path: it is rare,
correctness matters more than peak speed, and it works for any source →
target mesh pair. Each process restores its own blocks.
"""

import logging

logger = logging.getLogger(__name__)


def state_shardings(strategy, state):
    """The :class:`~tensorflowonspark_tpu_torch.parallel.sharding.Sharding`
    tree ``strategy`` assigns a TrainState, in a checkpoint's layout
    (``step``, ``params``, ``opt_state``, ``model_state``): parameters and
    the optimizer slots that mirror them by ``param_shardings``, everything
    else replicated, as ``create_state`` places them. Any other tree (a
    bare dict, or a TrainState restored without a target) replicates."""
    from tensorflowonspark_tpu_torch.parallel import sharding
    from tensorflowonspark_tpu_torch.train.strategy import TrainState

    rep = sharding.replicated(strategy.mesh)

    def replicate(tree):
        if isinstance(tree, dict):
            return {k: replicate(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(replicate(v) for v in tree)
        return rep

    if not isinstance(state, TrainState):
        return replicate(state)
    params = strategy.param_shardings(state.module)

    def opt(tree):
        if isinstance(tree, dict):
            if set(tree) == set(params):
                return dict(params)
            return {k: opt(v) for k, v in tree.items()}
        return replicate(tree)

    return {"step": rep, "params": params, "opt_state": opt(state.opt_state),
            "model_state": replicate(state.model_state)}


def reshard_restore(path, strategy=None, target=None, shardings=None):
    """Restore the checkpoint at ``path`` onto a new mesh / placement.

    With ``target``, a TrainState that ``strategy`` (a
    :class:`~tensorflowonspark_tpu_torch.train.strategy.SyncDataParallel`
    on the NEW mesh) created, the checkpoint is copied into it in place:
    the module's full parameters, and this rank's shard of each sharded
    parameter and optimizer slot. Otherwise the restored tree comes back
    with each tensor cut to this rank's block under ``shardings`` (a tree
    of ``Sharding``) or, by default, the placement ``strategy`` derives
    (:func:`state_shardings`), on the mesh's device.

    Values are bit-identical to the saved ones — resharding moves bytes,
    it never recomputes them.
    """
    from tensorflowonspark_tpu_torch.train import checkpoint

    if strategy is None and shardings is None:
        raise ValueError("reshard_restore needs a strategy or explicit shardings")
    if target is not None:
        restored = checkpoint.restore_checkpoint(path, target=target)
    else:
        host = checkpoint.restore_checkpoint(path)
        if shardings is None:
            shardings = state_shardings(strategy, host)
        restored = _place(host, shardings)
    logger.info("resharded checkpoint %s onto mesh %s", path, getattr(strategy, "mesh", None))
    return restored


def _place(tree, shardings):
    from tensorflowonspark_tpu_torch.parallel.sharding import place

    if isinstance(tree, dict):
        return {k: _place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, s) for v, s in zip(tree, shardings))
    return place(tree, shardings)
