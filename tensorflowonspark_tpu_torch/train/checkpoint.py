"""Checkpoint / export helpers (``torch.save``-backed) — the port of the JAX
package's ``train/checkpoint.py``.

Capability-parity with the reference's checkpoint story, which was fully
delegated to TensorFlow (SURVEY.md §5 "Checkpoint / resume"). A checkpoint
is a directory ``ckpt_<step>/`` holding one ``torch.save`` file of the
state's tree (:data:`STATE_FILE`) and ``MANIFEST.json`` (every file's size
and CRC32, written last), so staging, the commit protocol, cheap verify,
tear and prune work as in the JAX package. A
:class:`~tensorflowonspark_tpu_torch.train.strategy.TrainState` is saved in
the JAX package's layout: a sentinel, ``step``, ``params``, ``opt_state``
and ``model_state`` (always present), each a dict of host tensors by the
module's names.

A checkpoint holds full tensors whatever the state's placement: a state
sharded along ``fsdp`` (ZeRO-3) saves its module's full parameters and its
optimizer slots gathered to full size, and a module built from blocks over
``tp`` / ``ep`` saves its parameters and slots gathered from every rank's
blocks, as orbax saves full logical arrays, so a checkpoint is the same
bytes on any mesh. Gathering is collective: every rank of a sharded state
calls the save, and rank 0 writes.

Restoring into a live TrainState copies **in place**: the module's
parameters and buffers through ``load_state_dict``, ``copy_`` into every
optimizer-state tensor (the device ``count`` included; a sharded state
keeps this rank's shard of each full slot, and of each parameter), and
``state.step`` from the file, so a checkpoint lands on any strategy's
placement (``ckpt/reshard.py``). The tensors a captured CUDA graph points at
(``compile_train_loop``) stay the same objects, so a loop built before the
restore trains the restored values. Files are read with
``torch.load(weights_only=True)``: a checkpoint holds tensors and plain
containers only.

The JAX package retries a failed targeted restore with its older orbax
layout (checkpoints written before ``model_state`` was always saved); the
port never wrote that layout, so it has no such retry.
"""

import logging
import os

import torch

from tensorflowonspark_tpu_torch import chaos, durable, obs
from tensorflowonspark_tpu_torch.ckpt import manifest as ckpt_manifest
from tensorflowonspark_tpu_torch.ckpt.engine import TMP_MARKER

logger = logging.getLogger(__name__)

#: the one data file of a checkpoint directory
STATE_FILE = "state.pt"

#: marker key distinguishing a saved TrainState from a user's plain dict that
#: happens to have step/params/opt_state keys
_STATE_SENTINEL = "__train_state__"


def _to_saveable(state):
    """TrainState saves as a named dict so a target-less restore is
    self-describing; any other state is saved as it is."""
    from tensorflowonspark_tpu_torch.train.strategy import TrainState

    if isinstance(state, TrainState):
        # model_state is ALWAYS present (empty dict included) so the saved and
        # target tree structures agree regardless of whether the model carries
        # BN statistics
        params, opt_state = state.params, state.opt_state
        if state.sharded is not None:
            opt_state = state.sharded.full_tree(opt_state)
        if state.blocks is not None:
            params, opt_state = state.blocks.full_tree(params), state.blocks.full_tree(opt_state)
        return {
            _STATE_SENTINEL: 1,
            "step": int(state.step),
            "params": params,
            "opt_state": opt_state,
            "model_state": state.model_state,
        }
    return state


def save_is_collective(state):
    """True for a sharded state (along ``fsdp``, or in blocks over a model
    axis) in a world of more than one rank: every rank takes part in the
    save's gathers, and rank 0 alone writes."""
    import torch.distributed as dist

    sharded = getattr(state, "sharded", None) is not None or getattr(state, "blocks", None) is not None
    return sharded and dist.is_initialized() and dist.get_world_size() > 1


def _write_tree(path, tree):
    """``torch.save`` a host tree into ``path``/:data:`STATE_FILE`, fsynced
    (the manifest written after it describes durable bytes)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, STATE_FILE), "wb") as f:
        torch.save(tree, f)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint(path, state, force=True):
    """Save ``state`` (a TrainState or a tree of tensors) to the directory
    ``path``, blocking: the state is copied to host, written and fsynced
    into a ``tmp.`` staging dir beside ``path``, described by its manifest,
    and published by one rename (the async engine's commit protocol), so a
    process killed mid-save leaves no half-written checkpoint to resume
    from. ``force`` replaces an existing checkpoint at ``path``; without it
    an existing one raises.

    Under data parallelism every rank holds the same state: one rank saves
    (several ranks writing one directory would race). A state sharded over
    more than one rank is saved by every rank: each joins the gathers, rank
    0 writes, and all return once the checkpoint is published."""
    import shutil

    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.ckpt.snapshot import snapshot_to_host

    if save_is_collective(state) and dist.get_rank() != 0:
        _to_saveable(state)
        dist.barrier()
        return os.path.abspath(os.path.expanduser(path))
    path = os.path.abspath(os.path.expanduser(path))
    if os.path.isdir(path) and not force:
        raise FileExistsError("checkpoint {} exists (force=False)".format(path))
    parent = os.path.dirname(path)
    staging = os.path.join(parent, TMP_MARKER + os.path.basename(path))
    if os.path.isdir(staging):  # leftover of a save killed mid-write
        shutil.rmtree(staging, ignore_errors=True)
    snap = snapshot_to_host(state)
    snap.wait()
    _write_tree(staging, snap.tree)
    # manifest AFTER the full write, BEFORE the chaos tear: sync saves get
    # the same cheap-verify integrity story as the async engine's commits
    ckpt_manifest.write_manifest(staging)
    if chaos.active and chaos.fire("checkpoint.corrupt_write"):
        _tear_checkpoint(staging)
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.rename(staging, path)
    durable.fsync_dir(parent)
    logger.info("saved checkpoint to %s", path)
    if save_is_collective(state):
        dist.barrier()
    return path


def _tear_checkpoint(path):
    """Chaos fault ``checkpoint.corrupt_write``: leave the checkpoint torn on
    disk — the shape a host crash mid-write produces. Truncates the largest
    file (the state file). ``restore_latest`` must survive it."""
    files = []
    for root, _dirs, names in os.walk(path):
        for name in names:
            sub = os.path.join(root, name)
            try:
                files.append((os.path.getsize(sub), sub))
            except OSError:
                continue
    for _size, sub in sorted(files, reverse=True):
        try:
            with open(sub, "r+b") as f:
                f.truncate(max(0, os.path.getsize(sub) // 2))
            logger.warning("chaos: truncated checkpoint file %s", sub)
            return
        except OSError:
            continue


def _check_into(target, saved, where):
    """Raise unless ``saved`` fits the live ``target`` tree: the same keys
    and lengths, and every tensor the same shape and dtype."""
    if isinstance(target, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise TypeError("{}: checkpoint holds {}, the state a tensor".format(where, type(saved).__name__))
        if tuple(saved.shape) != tuple(target.shape) or saved.dtype != target.dtype:
            raise ValueError("{}: checkpoint {} {}, state {} {}".format(
                where, tuple(saved.shape), saved.dtype, tuple(target.shape), target.dtype))
    elif isinstance(target, dict):
        if not isinstance(saved, dict) or set(saved) != set(target):
            raise KeyError("{}: checkpoint keys {} differ from the state's {}".format(
                where, sorted(map(str, saved)) if isinstance(saved, dict) else type(saved).__name__,
                sorted(map(str, target))))
        for key, value in target.items():
            _check_into(value, saved[key], "{}/{}".format(where, key))
    elif isinstance(target, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(target):
            raise KeyError("{}: checkpoint and state lengths differ".format(where))
        for i, value in enumerate(target):
            _check_into(value, saved[i], "{}/{}".format(where, i))


@torch.no_grad()
def _copy_into(target, saved):
    """Copy ``saved`` into the live ``target`` tree in place (tensors keep
    their identity; dicts and lists are updated, not replaced). Returns the
    restored tree."""
    if isinstance(target, torch.Tensor):
        return target.copy_(saved)
    if isinstance(target, dict):
        for key in target:
            target[key] = _copy_into(target[key], saved[key])
        return target
    if isinstance(target, list):
        for i in range(len(target)):
            target[i] = _copy_into(target[i], saved[i])
        return target
    if isinstance(target, tuple):
        return type(target)(_copy_into(t, s) for t, s in zip(target, saved))
    return saved


def _from_saved(tree, target):
    from tensorflowonspark_tpu_torch.train.strategy import TrainState

    is_state = isinstance(tree, dict) and _STATE_SENTINEL in tree
    if isinstance(target, TrainState):
        if not is_state:
            raise KeyError("checkpoint holds no TrainState (no {!r} key)".format(_STATE_SENTINEL))
        blocks = target.blocks
        live = target.params if blocks is None else blocks.full_shapes(target.params)
        _check_into(dict(live, **target.model_state), dict(tree["params"], **tree["model_state"]), "module")
        opt_state, shapes = tree["opt_state"], target.opt_state
        if target.sharded is not None:
            shapes = target.sharded.full_shapes(shapes)
        if blocks is not None:
            shapes = blocks.full_shapes(shapes)
        _check_into(shapes, opt_state, "opt_state")
        params = tree["params"]
        if blocks is not None:
            params, opt_state = blocks.local_tree(params), blocks.local_tree(opt_state)
        if target.sharded is not None:
            opt_state = target.sharded.local_tree(opt_state)
        _check_into(target.opt_state, opt_state, "opt_state")
        with torch.no_grad():
            target.module.load_state_dict(dict(params, **tree["model_state"]), strict=True)
        if target.sharded is not None:
            target.sharded.reload()
        _copy_into(target.opt_state, opt_state)
        target.step = int(tree["step"])
        return target
    if is_state:
        tree = {k: v for k, v in tree.items() if k != _STATE_SENTINEL}
    if target is None:
        return tree
    _check_into(target, tree, "state")
    return _copy_into(target, tree)


def restore_checkpoint(path, target=None):
    """Restore the state saved at ``path``. Without ``target`` the tree
    comes back on the CPU (a TrainState as the dict of ``step``,
    ``params``, ``opt_state``, ``model_state``). With a live TrainState (or
    a tree of tensors) as ``target``, the checkpoint is copied into it in
    place — on whatever device its tensors live — and the target is
    returned; a checkpoint that does not fit it raises before anything is
    copied."""
    path = os.path.abspath(os.path.expanduser(path))
    if chaos.active and chaos.fire("checkpoint.restore_fail"):
        raise IOError("chaos: injected restore failure for {}".format(path))
    tree = torch.load(os.path.join(path, STATE_FILE), weights_only=True, map_location="cpu")
    state = _from_saved(tree, target)
    logger.info("restored checkpoint from %s", path)
    return state


def _numbered_checkpoints(model_dir, prefix="ckpt_"):
    """Sorted [(step, path)] of step-numbered checkpoint dirs under
    ``model_dir`` whose names start with ``prefix``."""
    model_dir = os.path.abspath(os.path.expanduser(model_dir))
    if not os.path.isdir(model_dir):
        return []
    steps = []
    for name in os.listdir(model_dir):
        sub = os.path.join(model_dir, name)
        if name.startswith(TMP_MARKER):
            # uncommitted staging dir of an async-engine commit in progress
            # (or torn by a crash): never a restore candidate, never pruned
            # here — even under prefix="" its *_<digits> tail would match
            continue
        if os.path.isdir(sub) and name.startswith(prefix):
            tail = name.rsplit("_", 1)[-1]
            if tail.isdigit():
                steps.append((int(tail), sub))
    return sorted(steps)


def latest_checkpoint(model_dir, prefix="ckpt_"):
    """Return the newest step-numbered checkpoint dir under ``model_dir``
    (the reference leaned on ``tf.train.latest_checkpoint``).

    Matches the same ``ckpt_`` prefix ``prune_checkpoints`` deletes, so a
    user-owned numbered sibling (``run_9``, export versions) can neither be
    mistaken for the resume point nor shadow the real one. Pass
    ``prefix=""`` to accept any ``*_<digits>`` layout."""
    steps = _numbered_checkpoints(model_dir, prefix)
    if not steps and prefix:
        # numbered dirs that the prefix gate excluded would otherwise turn
        # into a SILENT fresh start after a layout change — say so
        unmatched = _numbered_checkpoints(model_dir, "")
        if unmatched:
            logger.warning(
                "%s has %d step-numbered dir(s) (e.g. %s) but none match the "
                "%r prefix; resuming from scratch. Pass prefix=\"\" to accept "
                "any *_<digits> layout.",
                model_dir, len(unmatched), os.path.basename(unmatched[-1][1]), prefix,
            )
    return steps[-1][1] if steps else None


def restore_latest(model_dir, target=None, prefix="ckpt_"):
    """Restore the newest *restorable* checkpoint under ``model_dir``.

    Walks step-numbered checkpoints newest-first and returns
    ``(state, path)``. Manifest-carrying checkpoints (every save of this
    package) are **cheap-verified first** — stat + CRC32 against
    ``MANIFEST.json`` — so a torn or bitrotten candidate is rejected
    without paying for (or trusting) a restore attempt; manifest-less
    checkpoints keep the attempt-the-restore contract. Every skipped
    candidate is logged with *which* checkpoint was skipped and *why* (torn
    manifest, checksum mismatch, restore exception) and counted in
    ``checkpoint_restore_fallbacks_total``; a final warning summarizes the
    skips when an older checkpoint wins. Returns ``(None, None)`` when the
    directory has no checkpoints at all; raises only if every candidate
    failed (so "no checkpoints yet" stays a clean fresh start)."""
    steps = _numbered_checkpoints(model_dir, prefix)
    if not steps:
        latest_checkpoint(model_dir, prefix)  # emit the prefix-mismatch warning
        return None, None
    last_err = None
    skipped = []  # (path, reason) — the resume audit trail

    def _skip(path, reason):
        skipped.append((path, reason))
        obs.counter(
            "checkpoint_restore_fallbacks_total",
            help="checkpoints skipped as unrestorable during resume",
        ).inc()
        logger.warning(
            "skipping checkpoint %s: %s; falling back to an older one",
            path, reason,
        )

    for _step, path in reversed(steps):
        ok, reason = ckpt_manifest.verify(path)
        if not ok:
            _skip(path, reason)
            continue
        try:
            state = restore_checkpoint(path, target)
        except Exception as e:
            last_err = e
            _skip(path, "restore failed ({})".format(e))
            continue
        if skipped:
            logger.warning(
                "resumed from %s after skipping %d newer checkpoint(s): %s",
                path, len(skipped),
                "; ".join(
                    "{}: {}".format(os.path.basename(p), r) for p, r in skipped
                ),
            )
        return state, path
    if last_err is not None:
        raise last_err
    raise IOError(
        "no restorable checkpoint under {}: {}".format(
            model_dir,
            "; ".join("{}: {}".format(os.path.basename(p), r) for p, r in skipped),
        )
    )


def prune_checkpoints(model_dir, keep, in_flight=None):
    """Delete all but the newest ``keep`` step-numbered checkpoints (the
    ``tf.train.CheckpointManager(max_to_keep=...)`` capability: params +
    optimizer state add up fast on long runs and only the newest feeds the
    resume contract). Concurrent pruning by multiple saver processes is
    harmless — deletions race only against each other, on dirs nobody reads
    again. Returns the number of checkpoints removed.

    Two guards keep pruning safe against the async engine: uncommitted
    ``tmp.*`` staging dirs are never enumerated (``_numbered_checkpoints``
    skips them), and any path in the engine's in-flight registry
    (:func:`tensorflowonspark_tpu_torch.ckpt.engine.in_flight_paths`, or the
    explicit ``in_flight`` override) is exempt — a checkpoint mid-commit
    must never be deleted out from under its writer, even when a flood of
    newer commits would otherwise age it out."""
    import shutil

    if keep <= 0:
        return 0
    if in_flight is None:
        from tensorflowonspark_tpu_torch.ckpt.engine import in_flight_paths

        in_flight = in_flight_paths()
    busy = {os.path.abspath(os.path.expanduser(p)) for p in in_flight}
    # same ckpt_ gate as latest_checkpoint: rmtree must never touch sibling
    # numbered dirs the user owns (export versions, run_3, ...)
    ckpts = _numbered_checkpoints(model_dir)
    doomed = [(step, path) for step, path in ckpts[:-keep] if path not in busy]
    for _, path in doomed:
        shutil.rmtree(path, ignore_errors=True)
    return len(doomed)


def export_saved_model(model_dir, export_dir, state, is_chief=True):
    """Export final params for serving/inference.

    The checkpoint *is* the exchange format (it restores anywhere,
    including CPU inference executors); ``is_chief`` is accepted for
    reference API parity (compat.py:10-17)."""
    del model_dir  # kept for signature parity with the reference
    return save_checkpoint(export_dir, state)
