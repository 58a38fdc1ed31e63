"""Snapshot stage: copy the in-flight TrainState to host buffers.

The first half of the CheckFreq split (Mohan et al., FAST'21): decouple
*snapshot* (device → host, on the training thread, cheap) from *persist*
(host → storage, on the writer thread, slow). The training loop only ever
pays for enqueueing the device-to-host copies; the write happens behind it.

A snapshot walks the state's tree: for a
:class:`~tensorflowonspark_tpu_torch.train.strategy.TrainState` that is
``step``, the module's parameters, ``opt_state`` (the optimizer's device
``count`` included) and ``model_state`` (the BN running statistics), in the
layout a checkpoint file holds (``train/checkpoint._to_saveable``); any
other state is a tree of dicts, lists and tuples. Every leaf lands in
memory this module owns:

* the CUDA tensors are copied into **pinned** host tensors by one
  ``torch._foreach_copy_(..., non_blocking=True)`` on the current stream,
  and one CUDA event is recorded after the copies; :class:`HostSnapshot`
  carries it, and the writer waits on it (``event.synchronize()``) before
  it reads a byte;
* a CPU tensor or a numpy array is copied into an owned CPU tensor;
* Python scalars are kept as they are.

Ordered, not blocking: the copies are queued on the stream the training
step runs on, so the next step — which updates parameters, momentum and
BN statistics in place, eagerly or as a replayed CUDA graph — runs after
them on the card, and the training thread never waits for the device here.

Buffers are pooled double-buffer style (:class:`SnapshotBuffers`): with at
most one save in flight and at most one pending, two resident slots cover
the steady state, so per-snapshot allocation (and pinning) disappears after
warm-up on fixed-shape states (momentary overflow slots are allocated when
both are held and simply dropped on release).
"""

import logging
import threading
import time

import numpy as np
import torch

from tensorflowonspark_tpu_torch import chaos, obs

logger = logging.getLogger(__name__)


class HostSnapshot:
    """One host-resident copy of a state tree, tagged with its step.

    ``tree`` is the state's tree (a TrainState in its saved layout) with
    every tensor leaf replaced by an owned host tensor (what the writer
    hands to ``torch.save``); ``nbytes`` is the host footprint; ``slot`` is
    the pool slot backing the leaves (None for unpooled snapshots);
    ``event`` is the CUDA event recorded after the device-to-host copies
    (None when no leaf was on a card): the data is valid once it has
    completed (:meth:`wait`)."""

    __slots__ = ("tree", "step", "nbytes", "slot", "event")

    def __init__(self, tree, step, nbytes, slot=None, event=None):
        self.tree = tree
        self.step = step
        self.nbytes = nbytes
        self.slot = slot
        self.event = event

    def wait(self):
        """Block until the device-to-host copies have landed."""
        if self.event is not None:
            self.event.synchronize()


class _Slot:
    __slots__ = ("leaves", "signature", "event")

    def __init__(self, leaves, signature):
        self.leaves = leaves
        self.signature = signature
        self.event = None  # the last snapshot's copies into these buffers


def _saveable(state):
    from tensorflowonspark_tpu_torch.train import checkpoint

    return checkpoint._to_saveable(state)


def _flatten(tree, path=()):
    """``[(path, leaf)]`` of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        out = []
        for key, value in tree.items():
            out.extend(_flatten(value, path + (key,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, value in enumerate(tree):
            out.extend(_flatten(value, path + (i,)))
        return out
    return [(path, tree)]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the iterator
    ``leaves``."""
    if isinstance(tree, dict):
        return {key: _unflatten(value, leaves) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(value, leaves) for value in tree)
    return next(leaves)


def _leaf_sig(leaf):
    """(shape, dtype, where) of a leaf, read without touching its data (no
    device sync)."""
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), leaf.dtype, leaf.device.type)
    if isinstance(leaf, (np.ndarray, np.generic)):
        return (tuple(np.shape(leaf)), np.asarray(leaf).dtype.str, "numpy")
    return ((), type(leaf).__name__, "python")


def _signature(flat):
    """(paths, leaf shapes/dtypes/devices) of a flattened saved tree —
    computed WITHOUT touching leaf data, so slot matching is free."""
    return tuple((path, _leaf_sig(leaf)) for path, leaf in flat)


def _cpu_leaf_to_host(leaf, out=None):
    """Copy one host leaf into owned memory (into ``out`` when given): a
    CPU tensor or a numpy array becomes an owned CPU tensor, a Python
    scalar stays as it is."""
    if isinstance(leaf, (np.ndarray, np.generic)):
        leaf = torch.from_numpy(np.array(leaf, copy=True))
        return leaf if out is None else out.copy_(leaf)
    if not isinstance(leaf, torch.Tensor):
        return leaf
    if leaf.device.type != "cpu":
        raise ValueError("cannot snapshot a tensor on {}".format(leaf.device))
    return leaf.clone(memory_format=torch.contiguous_format) if out is None else out.copy_(leaf)


def snapshot_to_host(state, step=None, slot=None):
    """Copy ``state`` (a TrainState or a tree of tensors) into owned host
    buffers.

    The barrier-free point: called right after a step returns, the copies
    are queued behind *that step's* work on the current stream; nothing
    here waits for the device. Fires the ``ckpt.snapshot_stall`` chaos site
    and feeds ``ckpt_snapshot_seconds_total`` / ``ckpt_bytes_total``.

    Returns a :class:`HostSnapshot`; pass a pool ``slot`` (from
    :class:`SnapshotBuffers`) to reuse its buffers.
    """
    tree = _saveable(state)
    return _snapshot(tree, _flatten(tree), step, slot)


@torch.no_grad()
def _snapshot(tree, flat, step, slot):
    t0 = time.monotonic()
    if chaos.active:
        chaos.delay("ckpt.snapshot_stall")
    outs = slot.leaves if slot is not None else [None] * len(flat)
    host_leaves, dst, src = [], [], []
    for (_path, leaf), out in zip(flat, outs):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            if out is None:
                out = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
            dst.append(out)
            src.append(leaf)
            host_leaves.append(out)
        else:
            host_leaves.append(_cpu_leaf_to_host(leaf, out))
    event = None
    if src:
        stream = torch.cuda.current_stream(src[0].device)
        if slot is not None and slot.event is not None:
            # the slot's previous copies may still be queued on another stream
            stream.wait_event(slot.event)
        # one call queues every device-to-host copy (no return to Python
        # between them, so a writer thread holding the interpreter lock
        # cannot stall the training thread copy by copy), then one event
        # marks them done
        torch._foreach_copy_(dst, src, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    if slot is not None:
        slot.leaves = host_leaves
        slot.event = event
    nbytes = sum(t.numel() * t.element_size() for t in host_leaves if isinstance(t, torch.Tensor))
    elapsed = time.monotonic() - t0
    obs.counter(
        "ckpt_snapshot_seconds_total",
        help="seconds the training thread spent snapshotting state to host",
    ).inc(elapsed)
    obs.counter(
        "ckpt_bytes_total", help="bytes of state snapshotted to host buffers"
    ).inc(nbytes)
    return HostSnapshot(_unflatten(tree, iter(host_leaves)), step, nbytes, slot=slot, event=event)


class SnapshotBuffers:
    """Bounded pool of reusable host buffer slots (default depth 2: one
    backing the in-flight write, one for the next pending snapshot).

    ``take`` copies the state into a free slot — or a fresh overflow slot
    when the pool is exhausted or the state's shapes changed — and
    ``release`` returns pooled slots for reuse. Thread-safe: ``take`` runs
    on the training thread while ``release`` runs on the writer thread.
    """

    def __init__(self, depth=2):
        self.depth = depth
        self._lock = threading.Lock()
        self._free = []
        self._resident = 0  # pooled slots in existence (free + held)

    def take(self, state, step=None):
        tree = _saveable(state)
        flat = _flatten(tree)
        sig = _signature(flat)
        slot = None
        with self._lock:
            for i, cand in enumerate(self._free):
                if cand.signature == sig:
                    slot = self._free.pop(i)
                    break
            if slot is None and self._free and self._resident >= self.depth:
                # free slots exist but none match: the state's shapes
                # changed — evict a stale slot so the pool re-fills with
                # the new signature instead of pinning dead buffers
                self._free.pop(0)
                self._resident -= 1
            if slot is None and self._resident < self.depth:
                slot = _Slot([None] * len(sig), sig)
                self._resident += 1
        # overflow (both slots held, or shape change): unpooled snapshot
        return _snapshot(tree, flat, step, slot)

    def release(self, snap):
        slot = snap.slot
        if slot is None:
            return
        snap.slot = None
        with self._lock:
            if len(self._free) < self.depth:
                self._free.append(slot)
            else:
                self._resident -= 1
