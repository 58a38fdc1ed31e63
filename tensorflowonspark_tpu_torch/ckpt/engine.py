"""The async checkpoint engine: background writer + atomic commit.

Replaces the blocking save path (``train/checkpoint.py:save_checkpoint``
parks the training loop on ``wait_until_finished()``) with the
CheckFreq/Check-N-Run split: the training thread pays only the
snapshot-to-host copy (:mod:`tensorflowonspark_tpu_torch.ckpt.snapshot`); a
single daemon writer thread waits for the snapshot's device-to-host copies,
writes the tree (``torch.save``, ``train/checkpoint.py``) and performs the
manifest-committed publish in the background.

Queueing discipline — **at most one save in flight, newer supersedes
queued**: the hand-off slot holds at most one pending snapshot; a snapshot
arriving while one is still waiting replaces it (the superseded snapshot's
buffers return to the pool, ``ckpt_superseded_total`` counts the drop).
Checkpoints are *recovery points*, not an archive — when the writer falls
behind, persisting the newest state beats persisting every state, and the
training loop never blocks on storage (Check-N-Run's decoupled-frequency
argument).

Commit protocol (crash-atomic on POSIX rename semantics):

1. shards land in ``tmp.<prefix><step>`` next to the final dir,
2. ``MANIFEST.json`` (per-file sizes + CRC32s) is written last,
3. ``os.rename`` publishes ``<prefix><step>``.

A crash or a ``ckpt.commit_tear`` fault at any point leaves either an
unpublished staging dir — invisible to ``restore_latest`` and swept by the
next commit for the same step — or a fully manifest-described checkpoint.
Pruning runs on the writer thread after each commit and consults the
module-level in-flight registry (:func:`in_flight_paths`), so a prune can
never race the checkpoint another engine is still committing.

Chaos sites: ``ckpt.write_slow`` (writer delay inside the timed region),
``ckpt.commit_tear`` (die between shard write and publish; with
``publish_torn: true`` the checkpoint publishes with a torn manifest
instead, exercising the cheap-verify reject path), plus the pre-existing
``checkpoint.corrupt_write`` (shard bitrot *after* the manifest is
written, so the checksum mismatch is detectable).
"""

import logging
import os
import shutil
import threading
import time
import weakref

from tensorflowonspark_tpu_torch import chaos, durable, obs, resilience
from tensorflowonspark_tpu_torch.ckpt import manifest as _manifest
from tensorflowonspark_tpu_torch.ckpt.snapshot import SnapshotBuffers

logger = logging.getLogger(__name__)

#: staging-dir marker: ``tmp.<prefix><step>``. Never matches the ``ckpt_``
#: checkpoint prefix, so enumeration/restore/prune skip staging dirs by
#: construction.
TMP_MARKER = "tmp."

#: all live engines in this process (weak: an abandoned engine must not be
#: kept alive by the registry)
_engines = weakref.WeakSet()
_engines_lock = threading.Lock()


def in_flight_paths():
    """Final checkpoint paths some engine in this process is currently
    committing — the prune guard (``prune_checkpoints`` must never delete
    a checkpoint mid-commit)."""
    with _engines_lock:
        engines = list(_engines)
    return {p for e in engines for p in e.busy_paths()}


def drain_all(timeout=None):
    """Drain every live engine (pending + in-flight saves complete).
    Called from the node runtime on child exit so a worker never abandons
    a checkpoint it already snapshotted. Returns True when all drained;
    on timeout each stuck engine is named (checkpoint dir + pending step)
    so the operator knows *which* resume point was abandoned."""
    with _engines_lock:
        engines = list(_engines)
    deadline = resilience.Deadline(timeout)
    stuck = []
    for engine in engines:
        if not engine.drain(timeout=deadline.remaining()):
            stuck.append(engine.pending_desc() or repr(engine))
    if stuck:
        logger.warning(
            "checkpoint drain timed out (timeout=%s): %s",
            timeout, "; ".join(stuck),
        )
    return not stuck


def busy_descriptions():
    """Human-readable descriptions of every engine with undrained work
    (checkpoint dir + pending/committing step) — for exit-path logging."""
    with _engines_lock:
        engines = list(_engines)
    return [d for d in (e.pending_desc() for e in engines) if d]


class AsyncCheckpointEngine:
    """Non-blocking checkpointing for a training loop.

    ::

        engine = ckpt.AsyncCheckpointEngine(model_dir, keep=3, save_every_n=100)
        for i, batch in enumerate(batches):
            state, metrics = step(state, batch)
            engine.maybe_save(state, start_step + i + 1)
        engine.close()          # drain-on-exit: final save lands

    ``save`` snapshots synchronously (device → pooled host buffers, the
    only cost on the training thread) and returns immediately; the writer
    thread waits for the copies, serializes, commits, and prunes. The engine is also a context
    manager (``with`` = ``close()`` on exit, draining first).

    Writer failures never propagate into the training loop mid-run (a
    storage hiccup must not kill a healthy training job) — they are
    logged, counted (``ckpt_write_failures_total``) and surfaced on
    ``engine.error`` / at :meth:`close`.
    """

    def __init__(self, model_dir, keep=None, save_every_n=0, prefix="ckpt_",
                 buffer_depth=2):
        self.model_dir = os.path.abspath(os.path.expanduser(model_dir))
        self.keep = keep
        self.save_every_n = save_every_n
        self.prefix = prefix
        os.makedirs(self.model_dir, exist_ok=True)
        self._buffers = SnapshotBuffers(depth=buffer_depth)
        self._cond = threading.Condition()
        self._pending = None        # HostSnapshot awaiting the writer
        self._writing = False
        self._in_flight_path = None  # final path of the commit in progress
        self._closed = False
        self._last_error = None
        self._saves_accepted = 0
        self._thread = threading.Thread(
            target=self._run, name="tos-ckpt-writer", daemon=True
        )
        self._thread.start()
        with _engines_lock:
            _engines.add(self)

    # -- training-thread API --------------------------------------------------

    def save(self, state, step):
        """Snapshot ``state`` to host and queue it for background commit.

        Returns once the device-to-host copies are queued on the current
        stream — the next step, queued behind them, may update the state
        in place. A snapshot still waiting when the next
        one arrives is superseded (newest wins). It is dropped *before* the
        new snapshot is taken, so the new one reuses its pinned buffers: a
        writer slower than the cadence then keeps two buffer sets busy (the
        one it writes and the pending one), never a third.

        A state sharded over more than one rank is saved by every rank's
        engine (the snapshot gathers its shards, a collective); rank 0's
        writes, the others return once their part of the gathers is
        queued."""
        with self._cond:
            if self._closed:
                raise RuntimeError("AsyncCheckpointEngine is closed")
        import torch.distributed as dist

        from tensorflowonspark_tpu_torch.train import checkpoint

        if checkpoint.save_is_collective(state) and dist.get_rank() != 0:
            checkpoint._to_saveable(state)  # the gathers are collective; rank 0 writes
            return int(step)
        with self._cond:
            stale = self._supersede_locked(step)
        if stale is not None:
            self._buffers.release(stale)
        snap = self._buffers.take(state, step=int(step))
        with self._cond:
            if self._closed:
                self._buffers.release(snap)
                raise RuntimeError("AsyncCheckpointEngine is closed")
            stale = self._supersede_locked(step)  # a concurrent save got in first
            self._pending = snap
            self._saves_accepted += 1
            self._update_pending_gauge()
            self._cond.notify_all()
        if stale is not None:
            self._buffers.release(stale)
        return snap.step

    def _supersede_locked(self, step):
        """Drop the pending snapshot, if any (called under ``_cond``); the
        caller releases the returned snapshot's buffers."""
        superseded, self._pending = self._pending, None
        if superseded is None:
            return None
        self._update_pending_gauge()
        obs.counter(
            "ckpt_superseded_total",
            help="queued snapshots replaced by a newer one before "
                 "the writer picked them up",
        ).inc()
        logger.info(
            "checkpoint snapshot for step %s superseded by step %s",
            superseded.step, step,
        )
        return superseded

    def maybe_save(self, state, step):
        """The ``save_every_n`` loop hook: save when ``step`` lands on the
        cadence (and the engine has one configured). Returns True when a
        save was queued."""
        if self.save_every_n and step % self.save_every_n == 0:
            self.save(state, step)
            return True
        return False

    def drain(self, timeout=None):
        """Block until the pending and in-flight saves are fully committed
        (or ``timeout`` elapses). Returns True when drained; on timeout the
        warning names this engine (:meth:`pending_desc`)."""
        deadline = resilience.Deadline(timeout)
        with self._cond:
            while self._pending is not None or self._writing:
                if deadline.expired():
                    logger.warning(
                        "checkpoint drain timed out (timeout=%s): %s",
                        timeout, self._pending_desc_locked(),
                    )
                    return False
                self._cond.wait(timeout=deadline.clamp(1.0))
        return True

    def pending_desc(self):
        """``"<model_dir> (pending step N, committing step M)"`` for the
        work still undrained, or None when idle — so drain-timeout messages
        name the engine instead of a bare boolean."""
        with self._cond:
            return self._pending_desc_locked()

    def _pending_desc_locked(self):
        parts = []
        if self._pending is not None:
            parts.append("pending step {}".format(self._pending.step))
        if self._in_flight_path is not None:
            parts.append("committing {}".format(
                os.path.basename(self._in_flight_path)
            ))
        elif self._writing:
            parts.append("committing")
        if not parts:
            return None
        return "{} ({})".format(self.model_dir, ", ".join(parts))

    def close(self, timeout=None):
        """Drain, stop the writer thread, and surface any writer error.
        Idempotent; called by ``with``-exit."""
        drained = self.drain(timeout=timeout)
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=5.0)
        if not drained:
            logger.warning(
                "checkpoint engine %s closed before draining (timeout=%s)",
                self.model_dir, timeout,
            )
        if self._last_error is not None:
            raise self._last_error
        return drained

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            # error exit: best-effort drain, never mask the original error
            try:
                self.drain(timeout=60)
                with self._cond:
                    self._closed = True
                    self._cond.notify_all()
            except Exception:
                logger.exception("checkpoint drain failed during error exit")
        return False

    # -- introspection --------------------------------------------------------

    @property
    def error(self):
        """The writer's last failure (None = healthy)."""
        with self._cond:
            return self._last_error

    @property
    def saves_accepted(self):
        with self._cond:
            return self._saves_accepted

    def busy_paths(self):
        """Final paths this engine will still write to (pending +
        in-flight) — consumed by :func:`in_flight_paths`."""
        with self._cond:
            paths = set()
            if self._in_flight_path is not None:
                paths.add(self._in_flight_path)
            if self._pending is not None:
                paths.add(self._final_path(self._pending.step))
            return paths

    def _final_path(self, step):
        return os.path.join(self.model_dir, "{}{}".format(self.prefix, step))

    def _update_pending_gauge(self):
        # called under self._cond
        obs.gauge(
            "ckpt_pending",
            help="snapshots accepted but not yet committed (queued + in flight)",
        ).set((1 if self._pending is not None else 0) + (1 if self._writing else 0))

    # -- writer thread --------------------------------------------------------

    def _run(self):
        while True:
            with self._cond:
                while self._pending is None and not self._closed:
                    self._cond.wait()
                if self._pending is None:
                    return  # closed and drained
                snap = self._pending
                self._pending = None
                self._writing = True
                self._in_flight_path = self._final_path(snap.step)
                self._update_pending_gauge()
            try:
                self._write_and_commit(snap)
            except Exception as e:  # storage errors must not kill training
                with self._cond:
                    self._last_error = e
                obs.counter(
                    "ckpt_write_failures_total",
                    help="background checkpoint writes that failed",
                ).inc()
                logger.exception(
                    "background checkpoint write for step %s failed", snap.step
                )
            finally:
                self._buffers.release(snap)
                with self._cond:
                    self._writing = False
                    self._in_flight_path = None
                    self._update_pending_gauge()
                    self._cond.notify_all()

    def _write_and_commit(self, snap):
        from tensorflowonspark_tpu_torch.train import checkpoint as _ckpt

        final = self._final_path(snap.step)
        staging = os.path.join(
            self.model_dir, "{}{}{}".format(TMP_MARKER, self.prefix, snap.step)
        )
        if os.path.isdir(staging):  # leftover of a torn earlier commit
            shutil.rmtree(staging, ignore_errors=True)
        t0 = time.monotonic()
        if chaos.active:
            chaos.delay("ckpt.write_slow")
        # the pinned buffers are valid once the device-to-host copies the
        # snapshot queued have landed: never read one before
        snap.wait()
        _ckpt._write_tree(staging, snap.tree)
        _manifest.write_manifest(staging, step=snap.step)
        if chaos.active and chaos.fire("checkpoint.corrupt_write"):
            # bitrot AFTER the manifest: verify() must catch the mismatch
            _ckpt._tear_checkpoint(staging)
        if chaos.active:
            spec = chaos.fire("ckpt.commit_tear")
            if spec is not None:
                if spec.get("publish_torn"):
                    self._tear_manifest(staging)
                else:
                    logger.warning(
                        "chaos: commit torn before publish — leaving %s "
                        "unpublished", staging,
                    )
                    return  # the crash-before-rename shape
        if os.path.isdir(final):  # re-save of the same step: replace
            shutil.rmtree(final, ignore_errors=True)
        os.rename(staging, final)
        # restore-after-power-cut must see the publish: the step dir's
        # rename is only durable once the checkpoint root's entry is
        durable.fsync_dir(os.path.dirname(final))
        elapsed = time.monotonic() - t0
        obs.counter(
            "ckpt_write_seconds_total",
            help="seconds the background writer spent serializing + committing",
        ).inc(elapsed)
        obs.counter(
            "ckpt_commits_total", help="checkpoints published (manifest + rename)"
        ).inc()
        logger.info(
            "committed checkpoint %s (%.3fs, %d bytes snapshotted)",
            final, elapsed, snap.nbytes,
        )
        if self.keep:
            _ckpt.prune_checkpoints(self.model_dir, self.keep)

    @staticmethod
    def _tear_manifest(staging):
        """``ckpt.commit_tear`` with ``publish_torn``: the manifest write
        itself is interrupted mid-flush but the rename happens — the shape
        of a crash racing a non-atomic manifest write on a filesystem
        without rename durability. ``verify`` must reject it."""
        mpath = os.path.join(staging, _manifest.MANIFEST_NAME)
        try:
            size = os.path.getsize(mpath)
            with open(mpath, "r+b") as f:
                f.truncate(max(1, size // 2))
            logger.warning("chaos: tore manifest %s mid-commit", mpath)
        except OSError:
            pass
