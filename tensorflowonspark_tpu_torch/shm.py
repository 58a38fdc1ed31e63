"""Shared-memory feed chunks: the bulk-data lane of the feed plane.

The reference's feed plane pickled every row through a Manager proxy — its
hot loop (/root/reference/tensorflowonspark/TFSparkNode.py:430-434) put one
row per proxied call. Round 2 amortized the proxy round trip with
:class:`~tensorflowonspark_tpu_torch.marker.Chunk` (100 rows/message) but the row
payload still made two socket hops (feeder → manager process → jax child) as
pickle bytes. This module moves the payload out of band: the feeder lays the
chunk out as columnar numpy arrays in a ``multiprocessing.shared_memory``
segment and ships only a tiny descriptor through the Manager; the consumer
copies the columns out at memcpy speed and unlinks the segment.

Columnar layout is what the consumer wants anyway: ``DataFeed.next_batch``
(as_numpy=True) hands the arrays to ``jax.device_put`` without a Python-loop
transpose.

Only rows with a uniform numeric shape ride this lane (tuples/lists of
numeric fields, or bare numeric rows); anything else falls back to the
pickled :class:`Chunk` transparently — ``ShmChunk.from_rows`` returns None
and the caller keeps the old path.
"""

import logging
import secrets

from tensorflowonspark_tpu_torch.marker import Marker

logger = logging.getLogger(__name__)

#: /dev/shm name prefix for feed segments (diagnosable leaks: a crashed
#: consumer leaves ``tostfeed_*`` files behind; see ``unlink_leaked``). The
#: port's prefixes are its own: the JAX package's ``unlink_leaked`` sweeps
#: ``tosfeed_*`` / ``tosslab_*`` on the same host, and with a zero age (as its
#: tests call it) it would unlink the port's in-flight chunks
NAME_PREFIX = "tostfeed_"

#: /dev/shm name prefix for decode-plane batch slabs (long-lived pooled
#: segments owned by the creating pipeline, unlike the one-shot
#: ``tostfeed_`` chunks that die at materialize)
SLAB_PREFIX = "tostslab_"


def _unregister_from_tracker(name):
    """The creating process hands the segment's lifetime to the consumer;
    without this, the creator's resource_tracker unlinks it at process exit
    (racing the consumer) and spams leak warnings."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister("/" + name, "shared_memory")
    except Exception:
        pass


class ShmChunk(Marker):
    """Descriptor for one columnar chunk living in a shared-memory segment.

    Wire-side it is a tiny picklable object: segment ``name``, row ``count``,
    and per-column ``(dtype, shape, offset)``. ``single`` distinguishes bare
    rows (one column) from tuple rows (one column per field). ``py_cols``
    records, per column, whether the source values were Python objects
    (lists/ints/floats) rather than numpy — consumers use it to hand back
    the SAME types the feeder saw (a numpy-array row must come back numpy,
    a list row as a list)."""

    __slots__ = ("name", "count", "columns", "single", "py_cols")

    def __init__(self, name, count, columns, single, py_cols=None):
        self.name = name
        self.count = count
        self.columns = columns
        self.single = single
        self.py_cols = tuple(py_cols) if py_cols is not None else (True,) * len(columns)

    def __len__(self):
        return self.count

    # -- producer --------------------------------------------------------------

    @staticmethod
    def from_rows(rows):
        """Build a segment from a list of rows; None if the rows don't have a
        uniform numeric columnar shape (caller falls back to pickled Chunk)."""
        import numpy as np

        if not rows:
            return None
        first = rows[0]
        # Field-tuple rows ((features, label), sorted-input-cols tuples)
        # split one column per field; a bare numeric vector row (784 floats)
        # is ONE logical field. Nested fields or a small width mark a field
        # tuple; a wide all-scalar row stays multi only when its fields mix
        # dtype kinds (one unified column would silently upcast, e.g. an int
        # label among float features).
        def _mixed_kinds(row):
            kinds = set()
            for f in row:
                try:
                    kinds.add(np.asarray(f).dtype.kind)
                except Exception:
                    return False
            return len(kinds) > 1

        multi = (
            isinstance(first, (tuple, list))
            and not any(isinstance(f, (str, bytes)) for f in first)
            and (
                len(first) <= 16
                or any(isinstance(f, (list, tuple, np.ndarray)) for f in first)
                or _mixed_kinds(first)
            )
        )
        single = not multi

        def _is_py(value):
            return not isinstance(value, (np.ndarray, np.generic))

        try:
            if single:
                cols = [np.asarray(rows)]
                py_cols = [_is_py(first)]
            else:
                width = len(first)
                if any(len(r) != width for r in rows):
                    return None
                cols = [np.asarray([r[i] for r in rows]) for i in range(width)]
                py_cols = [_is_py(first[i]) for i in range(width)]
        except (ValueError, TypeError):
            return None
        for c in cols:
            if c.dtype == object or c.dtype.kind in "US":
                return None

        from multiprocessing import shared_memory

        total = sum(int(c.nbytes) for c in cols)
        name = NAME_PREFIX + secrets.token_hex(8)
        try:
            seg = shared_memory.SharedMemory(create=True, size=max(total, 1), name=name)
        except Exception:
            logger.warning("shared memory unavailable; feed falls back to pickle", exc_info=True)
            return None
        columns = []
        offset = 0
        for c in cols:
            c = np.ascontiguousarray(c)
            view = np.ndarray(c.shape, dtype=c.dtype, buffer=seg.buf, offset=offset)
            view[...] = c
            columns.append((c.dtype.str, c.shape, offset))
            offset += int(c.nbytes)
        seg.close()
        _unregister_from_tracker(name)
        return ShmChunk(name, len(rows), columns, single, py_cols)

    # -- consumer --------------------------------------------------------------

    def materialize(self):
        """Copy the columns out and unlink the segment; returns a list of
        numpy arrays (one per column)."""
        import numpy as np
        from multiprocessing import shared_memory

        seg = shared_memory.SharedMemory(name=self.name)
        try:
            out = [
                np.array(
                    np.ndarray(shape, dtype=np.dtype(dtype), buffer=seg.buf, offset=offset),
                    copy=True,
                )
                for dtype, shape, offset in self.columns
            ]
        finally:
            seg.close()
            # attach registered the segment with this process's tracker
            # (CPython pre-3.13 registers on attach too) and unlink()
            # UNREGISTERS it again — sending our own extra unregister after
            # that made the tracker's cache.remove() raise the KeyError
            # tracebacks seen in every dryrun log (MULTICHIP_r04 tail).
            # Only the unlink-already-gone path still needs the manual
            # unregister, to balance the attach-side registration.
            try:
                seg.unlink()
            except FileNotFoundError:
                _unregister_from_tracker(self.name)
        return out

    def rows(self):
        """Materialize as row objects: bare column entries for single-column
        chunks, tuples of per-field values otherwise (each a zero-copy view
        of the materialized column)."""
        cols = self.materialize()
        if self.single:
            return list(cols[0])
        return list(zip(*cols))

    def py_rows(self):
        """Materialize as TYPE-FAITHFUL rows: each field comes back as the
        kind of object the feeder saw — ``tolist`` for Python-sourced
        columns (lists/ints/floats, exact numeric round trip), numpy arrays
        kept numpy. The path for consumers iterating rows without
        ``as_numpy``."""
        raw = self.materialize()
        cols = [
            c.tolist() if py else list(c)
            for c, py in zip(raw, self.py_cols)
        ]
        if self.single:
            return cols[0]
        return list(zip(*cols))

    def discard(self):
        """Unlink without reading (drain paths). unlink() already
        unregisters from this process's tracker — see materialize()."""
        from multiprocessing import shared_memory

        try:
            seg = shared_memory.SharedMemory(name=self.name)
        except FileNotFoundError:
            return
        except Exception:
            logger.warning("failed to discard shm chunk %s", self.name, exc_info=True)
            return
        seg.close()
        try:
            seg.unlink()
        except FileNotFoundError:
            # lost an unlink race: balance the attach-side registration
            _unregister_from_tracker(self.name)
        except Exception:
            logger.warning("failed to discard shm chunk %s", self.name, exc_info=True)


class SlabSegment:
    """One pooled shared-memory slab: a named segment sized for a batch
    buffer, written in place by decode-plane worker processes and viewed
    zero-copy by the producer thread.

    Unlike :class:`ShmChunk` (one-shot: created by the feeder, unlinked by
    the consumer at materialize), a slab lives for the whole pipeline
    iteration and circulates through a free list — the creating process
    owns its lifetime end to end. Attachers (worker processes) call
    :meth:`attach`/:meth:`close`; only the creator calls :meth:`unlink`.
    """

    __slots__ = ("name", "nbytes", "_seg", "_creator")

    def __init__(self, name, nbytes, seg, creator):
        self.name = name
        self.nbytes = nbytes
        self._seg = seg
        self._creator = creator

    @classmethod
    def create(cls, nbytes):
        """Allocate a fresh ``tostslab_`` segment of ``nbytes`` (creator
        side). Raises whatever ``shared_memory`` raises when the platform
        has no usable shm — callers fall back to in-process buffers."""
        from multiprocessing import shared_memory

        name = SLAB_PREFIX + secrets.token_hex(8)
        seg = shared_memory.SharedMemory(create=True, size=max(int(nbytes), 1), name=name)
        return cls(name, seg.size, seg, creator=True)

    @classmethod
    def attach(cls, name):
        """Map an existing slab by name (worker side), with the attach-side
        resource_tracker registration suppressed (pre-3.13 ``SharedMemory``
        registers on attach unconditionally). Two reasons a worker must not
        register: a worker forked before the parent's tracker started would
        spawn its OWN tracker, which unlinks the slab when the worker is
        chaos-killed; and an unregister-after-register dance is not safe
        either — forked workers share one tracker whose cache is a set, so
        N workers' balanced pairs leave N-1 KeyError tracebacks in the
        tracker when the creator's unlink sends the final unregister."""
        from multiprocessing import resource_tracker, shared_memory

        orig_register = resource_tracker.register
        resource_tracker.register = lambda *a, **k: None
        try:
            seg = shared_memory.SharedMemory(name=name)
        finally:
            resource_tracker.register = orig_register
        return cls(name, seg.size, seg, creator=False)

    def ndarray(self, shape, dtype, offset=0):
        """Zero-copy numpy view over the slab (valid until :meth:`close`)."""
        import numpy as np

        return np.ndarray(shape, dtype=np.dtype(dtype), buffer=self._seg.buf, offset=offset)

    def close(self):
        """Drop this process's mapping — which UNMAPS it, dangling any live
        :meth:`ndarray` view (``mmap.close()`` does not honor numpy's base
        reference; observed as a segfault, not an error). Only for
        processes about to exit (decode workers at loop end); the creator
        tears down with :meth:`release` instead."""
        try:
            self._seg.close()
        except BufferError:
            pass

    def release(self):
        """Creator-side teardown: unlink the name and hand the mapping's
        lifetime to the outstanding numpy views. Closing here would unmap
        under any batch view the consumer still holds (see :meth:`close`),
        so the SharedMemory finalizer is disarmed instead — the mmap object
        then lives exactly as long as the last view's base reference and
        unmaps on its own deallocation. No leak, no dangling view."""
        self.unlink()
        self._seg._buf = None
        self._seg._mmap = None

    def unlink(self):
        """Remove the segment name (creator side). unlink() already
        unregisters from this process's tracker; the FileNotFoundError
        branch balances a lost race the same way ShmChunk.discard does."""
        try:
            self._seg.unlink()
        except FileNotFoundError:
            _unregister_from_tracker(self.name)
        except Exception:
            logger.warning("failed to unlink slab %s", self.name, exc_info=True)


def unlink_leaked(max_age_secs=86400):
    """Best-effort cleanup of ``tostfeed_*`` / ``tostslab_*`` segments left by
    crashed consumers (called from executor shutdown). Only touches segments
    older than ``max_age_secs`` to avoid racing in-flight chunks — the
    default is deliberately a full day (in-flight backlogs are bounded by
    feed timeouts, default 600 s); pass 0 only in tests that own every
    segment."""
    import os
    import time

    shm_dir = "/dev/shm"
    if not os.path.isdir(shm_dir):
        return 0
    removed = 0
    now = time.time()
    for fname in os.listdir(shm_dir):
        if not fname.startswith((NAME_PREFIX, SLAB_PREFIX)):
            continue
        path = os.path.join(shm_dir, fname)
        try:
            if now - os.stat(path).st_mtime >= max_age_secs:
                os.unlink(path)
                removed += 1
        except OSError:
            continue
    if removed:
        logger.info("unlinked %d leaked feed segments", removed)
    return removed
