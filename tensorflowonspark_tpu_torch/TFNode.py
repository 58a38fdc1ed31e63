"""Helper API available to user ``main_fun(args, ctx)`` code on each node.

Capability-parity with the reference's TFNode.py: filesystem
path normalization, cluster bootstrap, model export, and — the heart of
``InputMode.SPARK`` — the :class:`DataFeed` consumer that turns the executor's
IPC queue into host batches, which the trainer places on its device
(``SyncDataParallel.shard_batch``).

Differences from the reference:
* ``start_cluster_server`` (TF1 grpc bootstrap, reference TFNode.py:67-129) is
  replaced by ``ctx``-driven ``torch.distributed`` initialization
  (``ctx.initialize_distributed()``); a stub remains for API familiarity.
* ``DataFeed.next_batch`` can return columnar numpy arrays (``as_numpy=True``)
  so a batch can go onto the device without a Python-loop transpose.
"""

import collections
import getpass
import logging

from tensorflowonspark_tpu_torch import chaos
from tensorflowonspark_tpu_torch.marker import Chunk, EndPartition

logger = logging.getLogger(__name__)


def _is_shm_chunk(item):
    """Type check without importing numpy/shm on the common path."""
    from tensorflowonspark_tpu_torch.shm import ShmChunk

    return isinstance(item, ShmChunk)


class _Block:
    """Marks a multi-row columnar slice inside a per-tensor accumulator (the
    as_numpy+mapping fast lane appends these instead of scalars)."""

    __slots__ = ("arr",)

    def __init__(self, arr):
        self.arr = arr


def _merge_column(entries):
    """Assemble one output column from a mix of per-row values and
    :class:`_Block` slices, preserving order."""
    import numpy as np

    if not any(isinstance(e, _Block) for e in entries):
        return np.asarray(entries)
    parts, scalars = [], []
    for e in entries:
        if isinstance(e, _Block):
            if scalars:
                parts.append(np.asarray(scalars))
                scalars = []
            parts.append(np.asarray(e.arr))
        else:
            scalars.append(e)
    if scalars:
        parts.append(np.asarray(scalars))
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def _all_numpy(rows):
    """True when every row (and every field of tuple rows) is a numpy value —
    the precondition for type-faithful shared-memory results."""
    import numpy as np

    def _np(v):
        return isinstance(v, (np.ndarray, np.generic))

    return bool(rows) and all(
        all(_np(f) for f in r) if isinstance(r, (tuple, list)) else _np(r)
        for r in rows
    )

#: URI schemes recognized as absolute filesystem locations
#: (reference TFNode.py:40-49, plus ``gs`` as a first-class TPU-era scheme).
_FS_SCHEMES = (
    "file",
    "hdfs",
    "viewfs",
    "gs",
    "s3",
    "s3a",
    "s3n",
    "wasb",
    "wasbs",
    "adl",
    "abfs",
    "abfss",
)


def hdfs_path(ctx, path):
    """Normalize a path relative to the cluster's default filesystem.

    Mirrors reference TFNode.py:29-64: absolute URIs pass through, absolute
    paths are anchored at the default FS, relative paths land under the user's
    home directory on the default FS.
    """
    if any(path.startswith(scheme + "://") for scheme in _FS_SCHEMES):
        return path
    defaultFS = getattr(ctx, "defaultFS", None) or "file://"
    # normalize: keep the '://' but drop any trailing path slash so joins are clean
    base = defaultFS[:-1] if defaultFS.endswith("/") and not defaultFS.endswith("://") else defaultFS
    if path.startswith("/"):
        return base + path
    if base.startswith("file://"):
        # local FS: resolve relative to the working dir like the reference
        import os

        working = getattr(ctx, "working_dir", None) or os.getcwd()
        return "{}{}/{}".format(base, working, path)
    return "{}/user/{}/{}".format(base, getpass.getuser(), path)


def start_cluster_server(ctx, num_gpus=1, rdma=False):
    """Deprecated TF1-era bootstrap (reference TFNode.py:67-129).

    The distributed runtime is joined by ``ctx.initialize_distributed()``
    (torch.distributed over the reservation-elected coordinator); there is
    no per-node server object to start.
    """
    raise NotImplementedError(
        "start_cluster_server is a TF1 grpc concept; call "
        "ctx.initialize_distributed() and train on ctx.device instead."
    )


def export_saved_model(*args, **kwargs):
    """Reference TFNode.py:159 exported a TF1 SavedModel; here the export is
    a checkpoint (:func:`tensorflowonspark_tpu_torch.train.checkpoint.
    export_saved_model`)."""
    from tensorflowonspark_tpu_torch.train import checkpoint

    return checkpoint.export_saved_model(*args, **kwargs)


class DataFeed:
    """Consumer side of ``InputMode.SPARK`` feeding, running inside the trainer
    process; reads items the Spark feed tasks pushed through the executor IPC
    channel (reference TFNode.py:221-329).

    Semantics pinned by the reference and its tests:

    * ``None`` on the queue ⇒ end of feed; ``next_batch`` returns the partial
      batch and ``should_stop()`` becomes True (TFNode.py:267-272).
    * :class:`EndPartition` ⇒ end the current batch early without ending the
      feed (TFNode.py:273-278) — inference uses this to align results with
      partitions.
    * With ``input_mapping``, batches are dicts keyed by tensor/feature name,
      one list (or numpy array) per column, with columns matched to the sorted
      input column order (TFNode.py:261,281-286).
    """

    def __init__(self, mgr, train_mode=True, qname_in="input", qname_out="output", input_mapping=None, use_shm=None):
        import os

        self.mgr = mgr
        self.train_mode = train_mode
        self.qname_in = qname_in
        self.qname_out = qname_out
        self.done_feeding = False
        #: output-lane shared-memory gate: the driver's choice arrives via
        #: ctx.get_data_feed (cluster_meta["feed_shm"]); standalone DataFeeds
        #: fall back to this process's env
        self.use_shm = (
            os.environ.get("TOS_FEED_SHM", "1") == "1" if use_shm is None else bool(use_shm)
        )
        self.input_tensors = (
            [input_mapping[col] for col in sorted(input_mapping)] if input_mapping else None
        )
        #: rows unwrapped from a partially-consumed Chunk, served before the
        #: next proxied queue get (the consumer half of feed-plane chunking)
        self._pending = collections.deque()
        #: a partially-consumed ShmChunk kept COLUMNAR: (columns, single,
        #: cursor, total) — the fast lane for as_numpy+mapping consumers
        self._cols = None
        #: a dequeued Chunk whose task_done is deferred until every row is
        #: consumed — keeps the feeder's unfinished()==0 wait meaning "all
        #: rows trained", not "all messages dequeued"
        self._chunk_open = False

    def next_batch(self, batch_size, as_numpy=False):
        """Get up to ``batch_size`` items from the feed queue.

        Returns a list of items, or — when ``input_mapping`` was supplied — a
        dict of columns keyed by tensor name. ``as_numpy=True`` stacks columns
        into numpy arrays (device-put ready). One proxied queue get fetches a
        whole :class:`~tensorflowonspark_tpu_torch.marker.Chunk` of rows (vs the
        reference's one-round-trip-per-row loop, TFNode.py:243-288); a
        shared-memory chunk consumed by an ``as_numpy`` + ``input_mapping``
        consumer moves COLUMN SLICES, never Python rows — the near-zero-copy
        path from feeder numpy to the device placement
        (``SyncDataParallel.shard_batch``).
        """
        logger.debug("next_batch(%d)", batch_size)
        if chaos.active:
            chaos.delay("feed.slow_consumer")
        queue_in = self.mgr.get_queue(self.qname_in)
        tensors = [] if self.input_tensors is None else {t: [] for t in self.input_tensors}
        count = 0
        columnar_ok = as_numpy and self.input_tensors is not None

        def _consume(row):
            if self.input_tensors is None:
                tensors.append(row)
            else:
                for i, t in enumerate(self.input_tensors):
                    tensors[t].append(row[i])

        def _segment_done():
            self._cols = None
            if self._chunk_open:
                queue_in.task_done()
                self._chunk_open = False

        def _take_columnar(need):
            cols, single, py_cols, cursor, total = self._cols
            n = min(need, total - cursor)
            if columnar_ok and not single and len(cols) == len(self.input_tensors):
                # fast lane: one slice per tensor per chunk (no row objects)
                for i, t in enumerate(self.input_tensors):
                    tensors[t].append(_Block(cols[i][cursor : cursor + n]))
            else:
                # type-faithful rows: Python-sourced columns come back as
                # lists/scalars (tolist), numpy-sourced ones stay numpy —
                # the shm lane must hand user code the SAME kinds of
                # objects the pickled path would
                slices = [
                    c[cursor : cursor + n].tolist()
                    if (py and not as_numpy)
                    else c[cursor : cursor + n]
                    for c, py in zip(cols, py_cols)
                ]
                rows = list(slices[0]) if single else list(zip(*slices))
                for row in rows:
                    _consume(row)
            cursor += n
            if cursor >= total:
                _segment_done()
            else:
                self._cols = (cols, single, py_cols, cursor, total)
            return n

        while count < batch_size:
            if self._cols is not None:
                count += _take_columnar(batch_size - count)
                continue
            if self._pending:
                _consume(self._pending.popleft())
                count += 1
                if not self._pending and self._chunk_open:
                    queue_in.task_done()  # whole chunk now consumed
                    self._chunk_open = False
                continue
            item = queue_in.get(block=True)
            if item is None:
                # end-of-feed marker from shutdown (TFSparkNode.py:560-569)
                logger.info("next_batch: end of feed")
                queue_in.task_done()
                self.done_feeding = True
                break
            elif isinstance(item, EndPartition):
                # end current batch at a partition boundary
                logger.debug("next_batch: end of partition")
                queue_in.task_done()
                if count > 0:
                    break
            elif isinstance(item, Chunk):
                # pickled chunk: rows as the feeder sent them; task_done
                # deferred until the last row is consumed
                self._pending.extend(item.items)
                self._chunk_open = bool(self._pending)
                if not self._pending:  # defensive: empty chunk
                    queue_in.task_done()
            elif _is_shm_chunk(item):
                # shared-memory descriptor: payload never crossed the
                # Manager socket; keep it columnar and slice batches out
                cols = item.materialize()
                if item.count:
                    self._cols = (cols, item.single, item.py_cols, 0, item.count)
                    self._chunk_open = True
                else:
                    queue_in.task_done()
            else:
                _consume(item)
                count += 1
                queue_in.task_done()
        logger.debug("next_batch: returning %d items", count)
        if as_numpy:
            import numpy as np

            if self.input_tensors is None:
                return np.asarray(tensors)
            return {t: _merge_column(col) for t, col in tensors.items()}
        return tensors

    def should_stop(self):
        """True once the end-of-feed marker was consumed."""
        return self.done_feeding

    def batch_results(self, results):
        """Push a batch of inference results to the output queue — one
        chunked message per call; the contract stays 1:1 row-for-row with
        consumed inputs (reference TFNode.py:294-305). Uniform numeric
        results ride the shared-memory lane like the input feed."""
        results = list(results)
        if self.use_shm and _all_numpy(results):
            # numpy-only gate: shm materialization yields numpy values, so
            # only rows that are ALREADY numpy keep their exact types across
            # the lane; Python ints/floats/lists take the pickled path
            # (collectors would otherwise see np types, breaking e.g.
            # json.dumps of collected rows)
            from tensorflowonspark_tpu_torch.shm import ShmChunk

            chunk = ShmChunk.from_rows(results)
            if chunk is not None:
                self.mgr.get_queue(self.qname_out).put(chunk, block=True)
                return
        self.mgr.get_queue(self.qname_out).put(Chunk(results), block=True)

    def terminate(self):
        """Request feeder termination: flips the executor state machine to
        ``'terminating'`` and drains the input queue so blocked feed tasks can
        finish (reference TFNode.py:307-329)."""
        logger.info("DataFeed.terminate: requesting stop of data feed")
        self.mgr.set("state", "terminating")
        queue_in = self.mgr.get_queue(self.qname_in)
        # drain with a short patience window: feed tasks may still be pushing,
        # so the blocking get doubles as the inter-poll pacing
        empty_checks = 0
        while empty_checks < 3:
            try:
                item = queue_in.get(timeout=0.1)
                if _is_shm_chunk(item):
                    item.discard()  # unlink the unread segment
                queue_in.task_done()
                empty_checks = 0
            except Exception:
                empty_checks += 1
