"""Pipelined TFRecord→batch input path with device double-buffering.

The tf.data replacement for the InputMode.TENSORFLOW perf path (reference
input_fn: imagenet_preprocessing.py:259-323 — shard per worker, shuffle,
parallel parse, batch with drop_remainder, prefetch), restructured as a
three-stage pipeline so IO, decode and the device never wait on each other:

1. **Shard read-ahead** — a small reader executor streams the next
   ``readahead`` shards off disk while the parse pool decodes the current
   one (the ``interleave``/``prefetch`` overlap of the reference input_fn).
   Each reader pushes record *chunks* through a bounded queue, so a shard
   is never fully materialized just to be read.
2. **Streaming chunked reads** — shards arrive in ``chunk_records``-sized
   chunks (native ``tfr_stream_next`` when built, the Python codec
   otherwise), and a bounded ``shuffle_buffer`` re-orders records on the
   fly: the ``ds.shuffle(buffer)`` contract instead of whole-shard
   permutations, with peak memory of one buffer instead of one shard.
3. **Zero-copy batch assembly** — parse workers decode records straight
   into slots of a preallocated ``[B,H,W,C]`` batch buffer (no per-batch
   ``np.stack`` copy). With ``recycle_buffers=True`` the buffers circulate
   through a fixed pool instead of being reallocated per batch. With
   ``decode_workers > 0`` the parse stage moves off the GIL entirely: a
   :class:`~tensorflowonspark_tpu_torch.data.decode_plane.DecodePlane` of worker
   *processes* decodes records straight into shared-memory batch slabs and
   the pool becomes a cross-process slab free list — same slot-assignment
   algorithm, same byte-identical stream, different place the decode runs.

Stall accounting: the producer and consumer publish
``data_producer_read_seconds_total`` / ``data_producer_parse_seconds_total``
/ ``data_producer_emit_seconds_total`` / ``data_consumer_wait_seconds_total``
to :mod:`~tensorflowonspark_tpu_torch.obs`, so ``TFCluster.metrics()`` shows at a
glance whether a run is IO-bound (read time dominates), decode-bound (parse
dominates) or device-bound (emit blocks on the full prefetch queue while
the consumer never waits).
"""

import collections
import contextlib
import logging
import os
import queue
import threading
import time
import weakref
import zlib

import numpy as np

from tensorflowonspark_tpu_torch import chaos, obs, resilience
from tensorflowonspark_tpu_torch.data import autotune, decode_plane, slab_cache
from tensorflowonspark_tpu_torch.store import base as store_base

logger = logging.getLogger(__name__)

#: retry policy for opening/bulk-reading a shard: network filesystems
#: (gcsfuse, NFS) fail transiently under pressure and a re-open is cheap
#: next to losing the epoch. Mid-stream corruption is not retried — the
#: stream position is gone and corrupt bytes don't heal.
SHARD_READ_RETRY = resilience.RetryPolicy(
    max_attempts=3,
    backoff=resilience.Backoff(base=0.05, factor=2.0, max_delay=0.5, jitter=0.5),
    retry_on=(IOError,),
    name="loader-shard-read",
)

#: chunks a read-ahead reader may buffer per shard before blocking — bounds
#: memory to readahead * depth * chunk_records records
_CHUNK_QUEUE_DEPTH = 4

_SHARD_END = object()


class _ParseError:
    """Per-record parse failure carried out of the thread pool (a raised
    exception would abort the whole ``pool.map`` batch)."""

    __slots__ = ("error",)

    def __init__(self, error):
        self.error = error


class _Keyed:
    """A raw record tagged with its ``(path, index)`` decoded-cache key so
    the parse worker knows where to store the decoded result."""

    __slots__ = ("rec", "key")

    def __init__(self, rec, key):
        self.rec = rec
        self.key = key


class _Decoded:
    """A decoded-cache hit flowing through the stream in place of raw
    bytes — the parse stage passes it straight into the batch buffer."""

    __slots__ = ("image", "label")

    def __init__(self, image, label):
        self.image = image
        self.label = label


class _Stopped(Exception):
    """Consumer departed mid-iteration; unwind the producer quietly."""


def shard_files(files, num_shards, index):
    """Deterministic per-worker file sharding (the reference used
    ``ds.shard(num_workers, worker_num)``, mnist_inference.py:42 — same
    round-robin contract).

    Sorted by shard basename first, full path second
    (:func:`tensorflowonspark_tpu_torch.store.base.shard_sort_key`): a local glob
    and a remote URL listing of the same corpus order identically, so every
    worker gets the same shards no matter where the corpus lives."""
    files = sorted(files, key=store_base.shard_sort_key)
    if num_shards <= 1:
        return list(files)
    if index >= num_shards:
        raise ValueError("shard index {} out of range for {} shards".format(index, num_shards))
    return files[index::num_shards]


def _chunks_of(records, chunk_records):
    """Slice an in-memory record list into chunk_records-sized chunks
    (``chunk_records <= 0`` means one chunk: the bulk contract)."""
    if chunk_records <= 0:
        yield records
        return
    for i in range(0, len(records), chunk_records):
        yield records[i : i + chunk_records]


def _staged_or_cold(staged, path, store, verify_crc, chunk_records):
    """Chunks of ``path`` from its staged local copy, falling back to the
    cold remote read if the local copy fails before its first chunk — the
    window where the capacity bound may have evicted the staged directory
    between ``stager.fetch`` and the open. After the first chunk the file
    handle pins the bytes (POSIX unlink semantics), so a mid-stream error
    is a real one and surfaces."""
    try:
        it = _shard_chunk_iter(staged, verify_crc, chunk_records)
        first = next(it, None)
    except (OSError, IOError):
        logger.warning(
            "staged copy of %s unreadable (evicted or torn); reading cold", path
        )
        yield from _shard_chunk_iter(path, verify_crc, chunk_records, store=store)
        return
    if first is None:
        return
    yield first
    yield from it


def _shard_chunk_iter(path, verify_crc, chunk_records, store=None, stager=None):
    """Iterator of record-lists for one shard. ``chunk_records > 0``
    streams chunks (native ``tfr_stream_next`` for local files, the Python
    codec for fsspec URIs or a stale prebuilt library); ``chunk_records
    <= 0`` is the bulk path — the whole shard as a single chunk.

    Remote shards (``store`` handles the path) are served from the staged
    local copy when the prefetch ``stager`` has one (the read then falls
    through to the native local fast path below), or stream *cold* through
    the store's ranged chunk reads — same chunks, same bytes, either way.
    A staged copy that fails before its first chunk (evicted by the
    capacity bound between ``fetch`` and open, or corrupt on disk) falls
    back to the cold remote read — serve cold, never garbage."""
    from tensorflowonspark_tpu_torch import native_io, tfrecord

    if path.startswith("file://"):
        path = path[len("file://"):]
    if store is not None and store.handles(path):
        staged = stager.fetch(path) if stager is not None else None
        if staged is not None:
            store_base.note_backend("{} staged".format(store.fingerprint()))
            return _staged_or_cold(
                staged, path, store, verify_crc, chunk_records
            )
        elif chunk_records > 0:
            return store.read_records_chunked(
                path, chunk_records=chunk_records, verify_crc=verify_crc
            )
        else:
            return iter([store.read_records(path, verify_crc=verify_crc)])
    local = not tfrecord.is_uri(path)
    if chunk_records > 0:
        if local and native_io.stream_available():
            return native_io.read_records_chunked(
                path, chunk_records=chunk_records, verify_crc=verify_crc
            )
        return tfrecord.read_records_chunked(
            path, chunk_records=chunk_records, verify_crc=verify_crc
        )
    if local and native_io.available():
        return iter([native_io.read_records(path, verify_crc=verify_crc)])
    return iter([list(tfrecord.read_records(path, verify_crc=verify_crc))])


def _stop_put(q, item, stop, abort):
    """Bounded put that gives up when the pipeline is tearing down."""
    while not (stop.is_set() or abort.is_set()):
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _stop_get(q, stop):
    """Blocking get that returns None once the consumer has departed."""
    while not stop.is_set():
        try:
            return q.get(timeout=0.1)
        except queue.Empty:
            continue
    return None


def _shuffle_stream(records, rng, buffer_size):
    """Bounded streaming shuffle: the ``ds.shuffle(buffer_size)`` contract.

    Keeps at most ``buffer_size`` records buffered; each output is drawn
    uniformly from the buffer (swap-random-to-end, pop). Deterministic for
    a given ``rng`` and input order — and the input order is the shard
    order regardless of readahead/chunking, so the output stream is too.
    """
    buf = []
    for rec in records:
        buf.append(rec)
        if len(buf) >= buffer_size:
            j = int(rng.integers(len(buf)))
            buf[j], buf[-1] = buf[-1], buf[j]
            yield buf.pop()
    while buf:
        j = int(rng.integers(len(buf)))
        buf[j], buf[-1] = buf[-1], buf[j]
        yield buf.pop()


class ImagePipeline:
    """files → shuffled, parsed, fixed-shape batches of
    ``{"image": f32 [B,H,W,C], "label": i32 [B]}``.

    ``parse_fn(record_bytes) -> (image, label)`` comes from
    :mod:`~tensorflowonspark_tpu_torch.data.imagenet` / ``cifar``. Iterating yields
    ``steps_per_epoch * epochs`` batches (``epochs=None`` repeats forever).
    By default short final batches are dropped (static shapes for XLA, the
    reference's ``drop_remainder=True``); pass ``drop_remainder=False`` for
    complete-coverage eval (one extra compile for the short batch).

    Pipelining knobs (all deterministic: the record stream is byte-identical
    for a given ``seed`` regardless of ``readahead``, ``chunk_records`` or
    ``num_threads``):

    - ``readahead`` — how many shards the reader executor fetches ahead of
      the parse stage (default env ``TOS_DATA_READAHEAD`` or 2; 0 reads
      shards inline, no IO/parse overlap). ``"auto"`` lets a
      :class:`~tensorflowonspark_tpu_torch.data.autotune.ReadaheadAutotuner`
      steer the depth at runtime from the stall counters: deepen while the
      interval is io_bound and the consumer starves, shallow when the
      pipeline is comfortably ahead (published as ``readahead_depth``).
    - ``chunk_records`` — records per streamed chunk (default env
      ``TOS_DATA_CHUNK_RECORDS`` or 1024; 0 bulk-loads whole shards).
    - ``shuffle_buffer`` — bounded streaming shuffle window (the
      ``ds.shuffle(buffer)`` contract); ``<= 1`` disables record-level
      shuffling (shard order is still shuffled).
    - ``cache`` — ``"raw"`` keeps each shard's record bytes in memory after
      its first read (epochs ≥ 2 skip the filesystem); ``"decoded"``
      additionally keeps decoded ``(image, label)`` pairs so later epochs
      skip the parse too — only sound when ``parse_fn`` is deterministic
      per record (the imagenet/cifar parse_fns key their augmentation RNG
      to the record bytes, so they are). Caches persist across iterations
      of the same pipeline object; concurrent iterations of one cached
      pipeline are not supported.
    - ``recycle_buffers`` — emitted batch buffers circulate through a fixed
      pool instead of being reallocated. The yielded batch is then only
      valid until the *next* ``next()``; leave False (default) if batches
      are retained (e.g. ``list(pipe)``).
    - ``decode_workers`` — run the parse stage in worker *processes*
      decoding straight into shared-memory slabs (GIL-free; see
      :mod:`~tensorflowonspark_tpu_torch.data.decode_plane`). Default env
      ``TOS_DECODE_WORKERS`` or 0 = today's in-process thread pool;
      ``"auto"`` self-sizes from the parse/wait stall counters. Requires a
      fork start method, an importable/fork-inheritable ``parse_fn``
      (module-level factories like ``imagenet.make_parse_fn`` qualify) and
      ``multiprocessing.shared_memory`` — otherwise the thread pool is used
      with a warning. The delivered batch stream is byte-identical across
      thread and process modes.
    - ``slab_cache_dir`` — root for the cross-epoch decoded-slab cache
      (default env ``TOS_SLAB_CACHE_DIR``; unset = off). Decoded rows are
      persisted keyed by record crc32 under the ``parse_fn.cache_key``
      decode-parameter fingerprint, so epoch ≥ 2 — and an elastic relaunch
      over the same shards — fills slots from a memory map instead of
      decoding (see :mod:`~tensorflowonspark_tpu_torch.data.slab_cache`). Only
      active when the ``parse_fn`` exposes ``cache_key``; the stream stays
      byte-identical with the cache on, off, cold or warm.
    - ``store`` — an explicit
      :class:`~tensorflowonspark_tpu_torch.store.base.ShardStore` the shard paths
      live in. ``http(s)://`` shard lists auto-detect an
      :class:`~tensorflowonspark_tpu_torch.store.http.HTTPStore`; ``gs://`` /
      ``s3://`` corpora pass one explicitly with the matching endpoint
      adapter. The record stream is byte-identical to reading the same
      corpus from local disk.
    - ``prefetch`` — remote-shard staging window (default env
      ``TOS_STORE_PREFETCH`` or ``"auto"``): shards are downloaded to
      executor-local disk (``TOS_PREFETCH_DIR``) ahead of the reader and
      served through the native local fast path; ``"auto"`` lets the
      read-ahead autotuner steer the window from the stall counters
      (``store_prefetch_depth``); ``0`` streams cold through ranged remote
      reads. Only meaningful with a remote ``store``.

    ``max_bad_records`` is the poisoned-input budget: records whose
    ``parse_fn`` raises are skipped (counted in
    ``data_records_skipped_total``) until the budget is spent, then the
    parse error surfaces to the consumer. The default of 0 keeps the
    strict fail-fast contract; long production runs over petabyte-scale
    stores set a small tolerance so one torn record cannot kill an epoch.
    Batches stay full-size — good records backfill into the holes,
    preserving the static shapes XLA compiled for.
    """

    def __init__(
        self,
        files,
        parse_fn,
        batch_size,
        shuffle=True,
        seed=0,
        num_threads=None,
        epochs=1,
        prefetch_batches=2,
        verify_crc=False,
        drop_remainder=True,
        max_bad_records=0,
        readahead=None,
        chunk_records=None,
        shuffle_buffer=4096,
        cache=None,
        recycle_buffers=False,
        decode_workers=None,
        slab_cache_dir=None,
        store=None,
        prefetch=None,
    ):
        if not files:
            raise ValueError("no input files")
        self.files = list(files)
        # remote shard source: explicit store=, or auto-detected for
        # http(s):// shard lists (gs://, s3:// need an explicit store with
        # the matching endpoint adapter — never silently unauthenticated;
        # other URI schemes keep today's fsspec route)
        if store is None and any(
            str(f).startswith(("http://", "https://")) for f in self.files
        ):
            from tensorflowonspark_tpu_torch.store.http import resolve_store

            store = resolve_store(self.files)
        self.store = store
        #: remote prefetch window (``TOS_STORE_PREFETCH`` default: "auto" =
        #: stall-steered staging to local disk; "0" streams cold)
        self.prefetch = prefetch
        self._stager = None  # built per-iteration, after the plane forks
        self.parse_fn = parse_fn
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        # default threads from TOS_DATA_THREADS — the ML pipeline's `readers`
        # param lands here (reference HasReaders controlled enqueue threads)
        self.num_threads = num_threads or int(os.environ.get("TOS_DATA_THREADS", "8"))
        self.epochs = epochs
        self.prefetch_batches = prefetch_batches
        self.verify_crc = verify_crc
        #: training wants static shapes (XLA recompiles per shape); eval
        #: wants every example scored — drop_remainder=False emits the short
        #: final batch (one extra compile, complete coverage)
        self.drop_remainder = drop_remainder
        self.max_bad_records = int(max_bad_records)
        if readahead is None:
            readahead = os.environ.get("TOS_DATA_READAHEAD", "2")
        self.readahead_auto = str(readahead).strip().lower() == "auto"
        if self.readahead_auto:
            # stall-steered: the reader pool is sized to the ceiling; the
            # live depth starts shallow and the ReadaheadAutotuner moves it
            self.readahead = autotune.DEFAULT_MAX_READAHEAD
            self._ra_depth = [min(2, self.readahead)]
        else:
            self.readahead = max(0, int(readahead))
            self._ra_depth = [self.readahead]
        if chunk_records is None:
            chunk_records = int(os.environ.get("TOS_DATA_CHUNK_RECORDS", "1024"))
        self.chunk_records = max(0, int(chunk_records))
        self.shuffle_buffer = int(shuffle_buffer)
        if cache not in (None, "raw", "decoded"):
            raise ValueError(
                "cache must be None, 'raw' or 'decoded', got {!r}".format(cache)
            )
        self.cache = cache
        self.recycle_buffers = bool(recycle_buffers)
        self.decode_workers = decode_workers
        self.slab_cache_dir = slab_cache.resolve_dir(slab_cache_dir)
        # raw cache: path -> [record bytes], marked complete only after a
        # full clean read; decoded cache: (path, record index) -> _Decoded
        self._raw_cache = {}
        self._raw_complete = set()
        self._decoded = {}

    # -- stage 1+2: shard read-ahead and chunked streaming ---------------------

    def _is_cached(self, path):
        return self.cache is not None and path in self._raw_complete

    def _open_shard(self, path, chunk_records):
        """Open one shard as a chunk iterator; the ``data.shard_read`` chaos
        site injects delay or IOError here (retried under
        ``SHARD_READ_RETRY``, like the transient filesystem faults it
        models)."""
        if chaos.active:
            spec = chaos.fire("data.shard_read")
            if spec is not None:
                if spec.get("error"):
                    raise IOError(
                        "chaos: injected shard read failure for {}".format(path)
                    )
                time.sleep(spec.get("delay_s", 0.05))
        return _shard_chunk_iter(
            path, self.verify_crc, chunk_records,
            store=self.store, stager=self._stager,
        )

    def _decorate(self, path, base, records):
        """Swap records for decoded-cache hits / cache-keyed raw records.
        Misses (e.g. records left unparsed at an epoch-boundary teardown of
        the parse stage) fall back to the raw bytes kept by the raw cache."""
        if self.cache != "decoded":
            return records
        out = []
        for i, rec in enumerate(records):
            key = (path, base + i)
            out.append(self._decoded.get(key) or _Keyed(rec, key))
        return out

    def _shard_chunks_sync(self, path, read_c):
        """Yield one shard's record chunks, serving/filling the raw cache
        and accounting IO time into ``read_c``."""
        cs = self.chunk_records
        if self._is_cached(path):
            base = 0
            for chunk in _chunks_of(self._raw_cache[path], cs):
                yield self._decorate(path, base, chunk)
                base += len(chunk)
            return
        caching = self.cache is not None
        acc = [] if caching else None
        # the native library's first use builds or finds it (a g++ libjpeg
        # probe, a source hash) and loads it: a one-off cost, not shard IO,
        # so it is paid before the read clock starts
        from tensorflowonspark_tpu_torch import native_io

        native_io.load_library()
        t0 = time.monotonic()
        it = SHARD_READ_RETRY.call(self._open_shard, path, cs)
        read_c.inc(time.monotonic() - t0)
        base = 0
        while True:
            t0 = time.monotonic()
            chunk = next(it, None)
            read_c.inc(time.monotonic() - t0)
            if chunk is None:
                break
            if caching:
                acc.extend(chunk)
            yield self._decorate(path, base, chunk)
            base += len(chunk)
        # only reached on a clean EOF — an abandoned or failed read never
        # marks the shard complete
        if caching:
            self._raw_cache[path] = acc
            self._raw_complete.add(path)

    def _read_shard_task(self, path, q, stop, abort, read_c):
        """Reader-executor task: stream one shard's chunks into ``q``,
        terminated by ``_SHARD_END`` or the exception that broke the read."""
        try:
            for chunk in self._shard_chunks_sync(path, read_c):
                if chaos.active:
                    # a remote store gone slow: per-chunk latency inside the
                    # reader task, charged to read time so the stall
                    # classifier (and the readahead autotuner) sees io_bound
                    t0 = time.monotonic()
                    if chaos.delay("data.readahead_stall"):
                        read_c.inc(time.monotonic() - t0)
                if not _stop_put(q, chunk, stop, abort):
                    return
            _stop_put(q, _SHARD_END, stop, abort)
        except BaseException as e:  # delivered to the producer thread
            _stop_put(q, e, stop, abort)

    def _epoch_chunks(self, reader_pool, order, stop, abort, read_c):
        """Yield record chunks for one epoch in deterministic shard order,
        with up to ``readahead`` shards being read concurrently."""
        if reader_pool is None:
            for path in order:
                for chunk in self._shard_chunks_sync(path, read_c):
                    yield chunk
            return
        inflight = {}
        ahead = [0]

        def _top_up():
            # the live depth (not self.readahead): with readahead="auto"
            # the ReadaheadAutotuner moves it inside [1, self.readahead]
            while ahead[0] < len(order) and len(inflight) < self._ra_depth[0]:
                idx = ahead[0]
                ahead[0] += 1
                path = order[idx]
                if self._is_cached(path):
                    inflight[idx] = path  # in memory: serve synchronously
                    continue
                q = queue.Queue(maxsize=_CHUNK_QUEUE_DEPTH)
                fut = reader_pool.submit(
                    self._read_shard_task, path, q, stop, abort, read_c
                )
                inflight[idx] = (q, fut)

        _top_up()
        for k in range(len(order)):
            if k not in inflight:
                _top_up()
            entry = inflight.pop(k)
            _top_up()  # keep the read-ahead window full while we drain k
            if isinstance(entry, str):
                for chunk in self._shard_chunks_sync(entry, read_c):
                    yield chunk
                continue
            q, fut = entry
            while True:
                item = _stop_get(q, stop)
                if item is None:
                    raise _Stopped()
                if item is _SHARD_END:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
            fut.result()

    def _record_stream(self, reader_pool, stop, abort, read_c, on_epoch_end=None):
        # two independent RNGs: shard order must not depend on how many
        # records the shuffle buffer drew, or determinism across
        # shuffle_buffer settings would silently couple to shard sizes
        order_rng = np.random.default_rng(self.seed)
        shuffle_rng = np.random.default_rng((self.seed, 1))
        epoch = 0
        while self.epochs is None or epoch < self.epochs:
            order = list(self.files)
            if self.shuffle:
                order_rng.shuffle(order)
            if self._stager is not None:
                # the staging tier warms its window in this epoch's visit
                # order — the same order the reader executor will drain
                self._stager.plan(order)
            records = (
                rec
                for chunk in self._epoch_chunks(reader_pool, order, stop, abort, read_c)
                for rec in chunk
            )
            if self.shuffle and self.shuffle_buffer > 1:
                # buffer drains at epoch end: no cross-epoch record bleed
                records = _shuffle_stream(records, shuffle_rng, self.shuffle_buffer)
            for rec in records:
                yield rec
            if on_epoch_end is not None:
                # epoch boundary (shuffle buffer drained): the slab-cache
                # commit hook runs here, in the producer thread
                on_epoch_end()
            epoch += 1

    # -- stage 3: zero-copy batch assembly --------------------------------------

    def __iter__(self):
        """The batch stream. The decode plane (``decode_workers > 0``) forks
        its workers here, when ``iter()`` is called, not at the first
        ``next()``: a trainer takes its iterator before it touches CUDA, so
        the workers never start from a process with a CUDA context."""
        plane = None
        workers, auto = decode_plane.resolve_workers(self.decode_workers)
        if workers > 0:
            if decode_plane.available():
                tuner = (
                    decode_plane.DecodeAutotuner(
                        max_workers=max(workers, os.cpu_count() or 1)
                    )
                    if auto
                    else None
                )
                plane = decode_plane.DecodePlane(self.parse_fn, workers, autotuner=tuner)
            else:
                logger.warning(
                    "decode_workers=%s requested but fork/shared_memory is "
                    "unavailable here; falling back to the thread parse pool",
                    workers,
                )
        batches = self._batches(plane)
        if plane is not None:
            # a stream dropped before its first next() never runs its
            # finally: the plane goes down with the generator instead
            weakref.finalize(batches, plane.close)
        return batches

    def _batches(self, plane):
        from concurrent.futures import ThreadPoolExecutor

        B = self.batch_size
        out_q = queue.Queue(maxsize=max(1, self.prefetch_batches))
        stop = threading.Event()  # consumer departed
        abort = threading.Event()  # producer died: unblocks reader threads
        _END = object()
        free_q = queue.Queue()  # recycled (image, label) buffer pairs
        # buffers simultaneously alive: the prefetch queue, the producer's
        # in-progress batch, and the one the consumer still holds
        pool_cap = max(1, self.prefetch_batches) + 2
        alloc_count = [0]
        img_meta = {}

        produced_c = obs.counter(
            "data_batches_produced_total", help="batches parsed by the input pipeline"
        )
        consumed_c = obs.counter(
            "data_batches_consumed_total", help="batches handed to the training loop"
        )
        depth_g = obs.gauge(
            "data_prefetch_depth", help="parsed batches waiting in the prefetch queue"
        )
        skipped_c = obs.counter(
            "data_records_skipped_total",
            help="undecodable records skipped within the max_bad_records budget",
        )
        read_c = obs.counter(
            "data_producer_read_seconds_total",
            help="seconds spent in shard IO (open + chunk reads)",
        )
        parse_c = obs.counter(
            "data_producer_parse_seconds_total",
            help="seconds the parse pool spent decoding records into batch buffers",
        )
        emit_c = obs.counter(
            "data_producer_emit_seconds_total",
            help="seconds the producer blocked on a full prefetch queue "
            "(backpressure: the consumer is the bottleneck)",
        )
        wait_c = obs.counter(
            "data_consumer_wait_seconds_total",
            help="seconds the consumer waited on an empty prefetch queue "
            "(starvation: the input pipeline is the bottleneck)",
        )
        native_c = obs.counter(
            "decode_native_total",
            help="records decoded by the native JPEG path (no PIL)",
        )

        # the remote staging tier, rebuilt per iteration: its download pool
        # spawns threads only on first submit (inside the producer thread),
        # so constructing it here — after the plane forked — is fork-safe
        stager = None
        if self.store is not None:
            from tensorflowonspark_tpu_torch.store import staging as store_staging

            stager = store_staging.resolve_stager(self.store, prefetch=self.prefetch)
        self._stager = stager

        reader_pool = (
            ThreadPoolExecutor(self.readahead, thread_name_prefix="tos-data-reader")
            if self.readahead > 0
            else None
        )
        ra_tuner = None
        if reader_pool is not None and self.readahead_auto:
            ra_tuner = autotune.ReadaheadAutotuner(max_depth=self.readahead)
            ra_tuner.publish(self._ra_depth[0])

        # cross-epoch decoded-slab cache: constructed lazily once bootstrap
        # fixes the batch geometry (cache_box[0] stays None when off)
        cache_box = [None]
        cache_key = getattr(self.parse_fn, "cache_key", None)
        cache_root = self.slab_cache_dir if cache_key is not None else None
        # the thread-mode native fast path (process mode binds it in the
        # worker): only sound when the parse_fn advertises into-slab decode
        into = getattr(self.parse_fn, "into", None)

        def _final_put(item):
            # never block forever on a departed consumer: its finally drains
            # the queue and sets stop, so either the put lands or stop shows
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def _new_pair():
            # process mode mints a shared-memory slab (the view circulates
            # exactly like a plain buffer pair); thread mode a heap buffer
            if plane is not None:
                return plane.new_slab(B, img_meta["shape"], img_meta["dtype"])
            return (
                np.empty((B,) + img_meta["shape"], img_meta["dtype"]),
                np.empty((B,), np.int32),
            )

        def _acquire():
            # slabs are ALWAYS pooled (workers hold attachments by name);
            # plain buffers only when recycling was asked for
            if plane is None and not self.recycle_buffers:
                return _new_pair()
            try:
                return free_q.get_nowait()
            except queue.Empty:
                pass
            if alloc_count[0] < pool_cap:
                alloc_count[0] += 1
                return _new_pair()
            # pool exhausted: one timed-get path (no spin) until a buffer
            # comes back or the consumer departs
            t0 = time.monotonic()
            while True:
                if stop.is_set():
                    raise _Stopped()
                try:
                    pair = free_q.get(timeout=0.1)
                    break
                except queue.Empty:
                    continue
            if plane is not None:
                plane.note_slab_wait(time.monotonic() - t0)
            return pair

        def producer():
            bad = []  # parse errors absorbed so far (within budget)
            images = None  # current batch buffer [B, H, W, C]
            labels = None  # current label buffer [B]
            free_slots = []  # unfilled slot indices of the current buffer
            pending = []  # records awaiting a parse round

            def _parse_el(el):
                try:
                    if isinstance(el, _Decoded):
                        return el.image, el.label
                    rec, key = el, None
                    if isinstance(el, _Keyed):
                        rec, key = el.rec, el.key
                    img, lbl = self.parse_fn(rec)
                    img = np.asarray(img)
                    if key is not None:
                        self._decoded[key] = _Decoded(img, lbl)
                    return img, lbl
                except Exception as e:
                    return _ParseError(e)

            def _rec_bytes(el):
                """Raw record bytes of a stream element (None for a
                decoded-cache hit — nothing left to key or decode)."""
                if isinstance(el, _Decoded):
                    return None
                return el.rec if isinstance(el, _Keyed) else el

            def _parse_slot(el, slot):
                """Pool worker: decode ``el`` straight into buffer slot
                ``slot``. Distinct slots per worker — no write overlap."""
                if into is not None and not isinstance(el, _Decoded):
                    # native fast path: one C call lands decode+crop+resize+
                    # flip in the slot; any failure inside into() already
                    # fell back to PIL, so an exception here means the
                    # record is genuinely undecodable (budget accounting
                    # identical to the plain path)
                    rec, key = (el.rec, el.key) if isinstance(el, _Keyed) else (el, None)
                    try:
                        lbl, used_native = into(rec, images[slot])
                        labels[slot] = lbl
                    except Exception as e:
                        return (slot, _ParseError(e))
                    if used_native:
                        native_c.inc()
                    if key is not None:
                        self._decoded[key] = _Decoded(np.array(images[slot]), int(lbl))
                    return None
                p = _parse_el(el)
                if not isinstance(p, _ParseError):
                    try:
                        images[slot] = p[0]
                        labels[slot] = p[1]
                        return None
                    except Exception as e:  # shape/dtype mismatch vs slot 0
                        p = _ParseError(e)
                return (slot, p)

            def _absorb(err):
                if len(bad) >= self.max_bad_records:
                    raise err
                bad.append(err)
                skipped_c.inc()
                logger.warning("skipping undecodable record: %s", err)

            def _emit(img_out, lbl_out):
                if chaos.active:
                    chaos.delay("data.producer_delay")
                batch = {"image": img_out, "label": lbl_out}
                t0 = time.monotonic()
                while True:
                    try:
                        out_q.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        if stop.is_set():
                            raise _Stopped()
                emit_c.inc(time.monotonic() - t0)
                produced_c.inc()
                depth_g.set(out_q.qsize())

            def _next_buffers():
                nonlocal images, labels, free_slots
                images, labels = _acquire()
                free_slots = list(range(B))

            def _emit_full():
                # a full batch goes out; in non-recycle process mode the
                # slab view is copied out and returned to the pool at once
                # (the consumer only recycles when recycle_buffers is set)
                if plane is not None and not self.recycle_buffers:
                    _emit(np.array(images), labels.copy())
                    free_q.put((images, labels))
                else:
                    _emit(images, labels)
                _next_buffers()

            def _slab_hit(el, slot):
                """Serve ``el`` from the cross-epoch slab cache if it can:
                the cached row is written into the slot parent-side (the
                hit leases the slot without touching a worker or a pool
                thread). Returns the record's crc (a miss, to be staged
                after decode), True (served), or None (cache off /
                already-decoded element)."""
                cache = cache_box[0]
                rec = _rec_bytes(el)
                if cache is None or rec is None:
                    return None
                crc = zlib.crc32(rec)
                hit = cache.lookup(crc)
                if hit is None:
                    return crc
                images[slot] = hit[0]
                labels[slot] = hit[1]
                if isinstance(el, _Keyed):
                    self._decoded[el.key] = _Decoded(
                        np.array(images[slot]), int(labels[slot])
                    )
                return True

            def _plane_round(els, slots):
                """Decode one round on the process plane: cache hits are
                written inline (already-decoded pixels never cross a
                process), raw records lease slab slots to the workers, and
                keyed slots flow back into the decoded cache *via the
                slab* — no pickle on the result path."""
                results = []
                tasks = []
                keyed = {}
                crcs = {}  # slot -> record crc for slab-cache misses
                for el, slot in zip(els, slots):
                    if isinstance(el, _Decoded):
                        try:
                            images[slot] = el.image
                            labels[slot] = el.label
                        except Exception as e:  # shape/dtype mismatch
                            results.append((slot, _ParseError(e)))
                        continue
                    try:
                        served = _slab_hit(el, slot)
                    except Exception as e:  # cached-row geometry mismatch
                        results.append((slot, _ParseError(e)))
                        continue
                    if served is True:
                        continue
                    if served is not None:
                        crcs[slot] = served
                    rec, key = el, None
                    if isinstance(el, _Keyed):
                        rec, key = el.rec, el.key
                    if key is not None:
                        keyed[slot] = key
                    tasks.append((slot, rec))
                try:
                    failures = plane.run_round(
                        images, labels, tasks, should_stop=stop.is_set
                    )
                except decode_plane.Stopped:
                    raise _Stopped()
                failed = set()
                for slot, err in failures:
                    failed.add(slot)
                    results.append((slot, _ParseError(err)))
                for slot, key in keyed.items():
                    if slot not in failed:
                        self._decoded[key] = _Decoded(
                            np.array(images[slot]), int(labels[slot])
                        )
                if cache_box[0] is not None:
                    for slot, crc in crcs.items():
                        if slot not in failed:
                            cache_box[0].put(crc, images[slot], labels[slot])
                plane.autotune_tick()
                return results

            def _thread_round(els, slots):
                """Decode one round on the in-process pool: slab-cache hits
                are written inline by the producer (the cache is
                single-threaded by contract), misses fan out to the pool
                and their freshly decoded rows are staged back."""
                results = []
                run_els = []
                run_slots = []
                crcs = {}
                for el, slot in zip(els, slots):
                    try:
                        served = _slab_hit(el, slot)
                    except Exception as e:  # cached-row geometry mismatch
                        results.append((slot, _ParseError(e)))
                        continue
                    if served is True:
                        continue
                    if served is not None:
                        crcs[slot] = served
                    run_els.append(el)
                    run_slots.append(slot)
                results.extend(
                    r for r in pool.map(_parse_slot, run_els, run_slots) if r is not None
                )
                if cache_box[0] is not None and crcs:
                    failed = {slot for slot, _ in results}
                    for slot, crc in crcs.items():
                        if slot not in failed:
                            cache_box[0].put(crc, images[slot], labels[slot])
                return results

            def _round():
                # parse all pending records into the lowest free slots;
                # failures leave holes that the next records backfill, so
                # emitted batches stay full-size
                nonlocal free_slots, pending
                if not pending:
                    return
                slots = free_slots[: len(pending)]
                t0 = time.monotonic()
                if plane is not None:
                    results = _plane_round(pending, slots)
                else:
                    results = _thread_round(pending, slots)
                parse_c.inc(time.monotonic() - t0)
                if ra_tuner is not None:
                    target = ra_tuner.tick(self._ra_depth[0])
                    if target is not None:
                        self._ra_depth[0] = target
                pending = []
                holes = []
                for slot, perr in results:
                    _absorb(perr.error)
                    holes.append(slot)
                free_slots = free_slots[len(slots):] + holes
                if not free_slots:
                    _emit_full()

            def _bootstrap(el):
                # the first good record defines the batch geometry: its
                # shape and dtype size the preallocated buffers (only f64 is
                # narrowed — uint8 parses quarter the host->device bytes)
                nonlocal free_slots
                p = _parse_el(el)
                if isinstance(p, _ParseError):
                    _absorb(p.error)
                    return
                img = np.asarray(p[0])
                img_meta["shape"] = img.shape
                img_meta["dtype"] = np.float32 if img.dtype == np.float64 else img.dtype
                if cache_root is not None:
                    # geometry is now known: open (or create) the decoded-
                    # slab cache scoped by the decode-parameter fingerprint
                    try:
                        cache_box[0] = slab_cache.SlabCache(
                            cache_root, cache_key, img_meta["shape"], img_meta["dtype"]
                        )
                    except Exception as e:
                        logger.warning("decoded-slab cache disabled: %s", e)
                _next_buffers()
                images[0] = img
                labels[0] = p[1]
                free_slots = free_slots[1:]
                rec = _rec_bytes(el)
                if cache_box[0] is not None and rec is not None:
                    cache_box[0].put(zlib.crc32(rec), images[0], labels[0])
                if not free_slots:
                    _emit_full()

            def _epoch_end():
                # flush the epoch's tail round so its rows make this commit
                # (slot assignment is unchanged: the same records land in
                # the same lowest free slots, just one round earlier), then
                # seal the staged generation — epoch >= 2 reads it back
                _round()
                if cache_box[0] is not None:
                    cache_box[0].commit()

            try:
                # with a decode plane the parse happens out of process; the
                # in-process pool (and its threads) never spawns
                pool_cm = (
                    contextlib.nullcontext()
                    if plane is not None
                    else ThreadPoolExecutor(self.num_threads)
                )
                with pool_cm as pool:
                    for rec in self._record_stream(
                        reader_pool, stop, abort, read_c, on_epoch_end=_epoch_end
                    ):
                        if stop.is_set():
                            return
                        # poison is rolled here, in the producer thread, so
                        # the seeded schedule is independent of reader/parse
                        # thread timing (chaos call-order determinism)
                        if chaos.active and chaos.fire("data.poison"):
                            if isinstance(rec, _Keyed):
                                rec = _Keyed(b"\x00chaos-poisoned-record", rec.key)
                            elif not isinstance(rec, _Decoded):
                                rec = b"\x00chaos-poisoned-record"
                        if images is None:
                            _bootstrap(rec)
                            continue
                        pending.append(rec)
                        if len(pending) >= len(free_slots):
                            _round()
                    if pending:
                        _round()
                    if images is not None and 0 < len(free_slots) < B and not self.drop_remainder:
                        # fancy indexing copies out of the recycled buffer:
                        # a short batch is never handed out aliased
                        keep = sorted(set(range(B)) - set(free_slots))
                        _emit(images[keep], labels[keep])
                    # else: short remainder dropped (one static shape)
            except _Stopped:
                return
            except BaseException as e:  # surfaced on the consuming side
                _final_put(e)
                return
            finally:
                if cache_box[0] is not None:
                    # uncommitted staging is discarded (the commit contract:
                    # a generation exists fully or not at all)
                    cache_box[0].close()
                _final_put(_END)
                abort.set()
                if reader_pool is not None:
                    reader_pool.shutdown(wait=False, cancel_futures=True)
                if stager is not None:
                    self._stager = None
                    stager.close()

        thread = threading.Thread(target=producer, name="tos-data-producer", daemon=True)
        thread.start()
        prev = None
        try:
            while True:
                if (
                    self.recycle_buffers
                    and prev is not None
                    and prev["image"].shape[0] == B
                ):
                    # the previous batch is done with (the "valid until the
                    # next next()" contract) — its buffers go back in the pool
                    free_q.put((prev["image"], prev["label"]))
                prev = None
                t0 = time.monotonic()
                item = out_q.get()
                wait_c.inc(time.monotonic() - t0)
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                consumed_c.inc()
                depth_g.set(out_q.qsize())
                prev = item
                yield item
        finally:
            stop.set()
            # unblock the producer if it is waiting on a full queue (empty()
            # instead of catching Empty: exception classes may already be
            # torn down when a half-consumed generator is GC'd at exit)
            while not out_q.empty():
                out_q.get_nowait()
            if plane is not None:
                # the producer observes stop within one poll interval; only
                # after it is out of the lease protocol is the plane torn
                # down (workers drained, slab pool unlinked)
                thread.join(timeout=10.0)
                plane.close()


class PinnedPlacer:
    """Places host batches on ``strategy``'s device ahead of their use.

    On a CUDA device a batch's arrays are copied into pinned host buffers
    (a ring of ``slots``, reused once their last transfer has left them) and
    sent with non-blocking copies on a stream of their own, so the
    transfers run while the card computes the steps before them:
    ``shard_batch`` of pageable numpy memory would be a synchronous copy on
    the compute stream. :meth:`place` returns the device batch and the
    event its transfer records; :meth:`ready` makes the current stream wait
    for that event, which the prefetchers below do as they hand a batch
    out, so a consumer uses it as it would any device batch. On the CPU
    :meth:`place` is ``strategy.shard_batch``.
    """

    def __init__(self, strategy, slots):
        self.strategy = strategy
        self.cuda = strategy.device.type == "cuda"
        if self.cuda:
            import torch

            self.stream = torch.cuda.Stream(strategy.device)
            self.slots = [{} for _ in range(max(1, slots))]
            self.sent = [None] * len(self.slots)
            self.turn = 0

    def place(self, batch, stacked=False):
        """``(device batch, event or None)`` of ``batch``: a dict of arrays,
        or with ``stacked`` a list of such dicts, stacked into one
        ``[len, ...]`` batch on the host (straight into the pinned buffer).
        A profiler trace sees it as the ``loader.place`` range."""
        from torch.autograd.profiler import record_function

        with record_function("loader.place"):
            return self._place(batch, stacked)

    def _place(self, batch, stacked):
        if not self.cuda:
            if stacked:
                batch = {key: np.stack([b[key] for b in batch]) for key in batch[0]}
            return self.strategy.shard_batch(batch), None
        import torch

        j = self.turn % len(self.slots)
        self.turn += 1
        if self.sent[j] is not None:
            self.sent[j].synchronize()  # the slot's last transfer has left it
        slot, device = self.slots[j], self.strategy.device
        consumer = torch.cuda.current_stream(device)
        keys = batch[0].keys() if stacked else batch.keys()
        out = {}
        with torch.cuda.stream(self.stream):
            for key in keys:
                if not stacked and isinstance(batch[key], int):  # a host value stays on the host
                    out[key] = batch[key]
                    continue
                parts = [np.asarray(b[key]) for b in batch] if stacked else [np.asarray(batch[key])]
                shape = ((len(parts),) if stacked else ()) + parts[0].shape
                dtype = torch.from_numpy(np.empty(0, parts[0].dtype)).dtype
                host = slot.get(key)
                if host is None or tuple(host.shape) != shape or host.dtype != dtype:
                    host = slot[key] = torch.empty(shape, dtype=dtype, pin_memory=True)
                if stacked:
                    np.stack(parts, out=host.numpy())
                else:
                    np.copyto(host.numpy(), parts[0])
                t = host.to(device, non_blocking=True)
                t.record_stream(consumer)
                out[key] = t
            event = torch.cuda.Event()
            event.record(self.stream)
        self.sent[j] = event
        return out, event

    def ready(self, event):
        """Make the current stream wait for a placement's transfer."""
        if event is not None:
            import torch

            torch.cuda.current_stream(self.strategy.device).wait_event(event)


def device_prefetch(batches, strategy, depth=2):
    """Shard host batches onto the device ``depth`` steps ahead of the
    consumer (the ``tf.data.prefetch``-to-device analogue): while the device
    crunches step N, the host is already transferring N+1, through pinned
    buffers on a copy stream (:class:`PinnedPlacer`)."""
    placer = PinnedPlacer(strategy, depth + 2)
    buf = collections.deque()
    it = iter(batches)
    try:
        for _ in range(depth):
            buf.append(placer.place(next(it)))
    except StopIteration:
        pass
    while buf:
        out, event = buf.popleft()
        try:
            buf.append(placer.place(next(it)))
        except StopIteration:
            pass
        placer.ready(event)
        yield out


def loop_prefetch(batches, strategy, num_steps, depth=None):
    """Group host batches into device-resident lists of ``num_steps`` for
    :meth:`~tensorflowonspark_tpu_torch.train.SyncDataParallel.compile_train_loop`.

    Each batch is placed as it arrives, through pinned buffers on a copy
    stream (:class:`PinnedPlacer`), so the transfers overlap the previous
    window's steps (on the card: its graph replays), and handed out in
    windows of ``num_steps``. ``depth`` is how many batches beyond the
    current window stay in flight (default ``num_steps``, i.e. the next
    window transfers while the current one trains). Short final windows are
    dropped (the loop is compiled for a static ``num_steps``).
    """
    if depth is None:
        depth = num_steps
    placer = PinnedPlacer(strategy, num_steps + depth + 1)
    buf = collections.deque()
    it = iter(batches)

    def window():
        out = []
        for _ in range(num_steps):
            batch, event = buf.popleft()
            placer.ready(event)
            out.append(batch)
        return out

    try:
        while True:
            while len(buf) < num_steps + depth:
                buf.append(placer.place(next(it)))
            yield window()
    except StopIteration:
        pass
    while len(buf) >= num_steps:
        yield window()


def packed_prefetch(batches, strategy, num_steps, depth=1):
    """Group host batches into device-resident ``[num_steps, B, ...]`` stacks,
    each shipped as ONE host→device transfer, double-buffered ``depth``
    windows ahead — for :meth:`compile_train_loop(packed=True)
    <tensorflowonspark_tpu_torch.train.SyncDataParallel.compile_train_loop>`.

    Use this instead of :func:`loop_prefetch` when the device link has a
    large per-transfer fixed cost: one big transfer per window amortizes it
    ``num_steps``×. The window is stacked on the host straight into a pinned
    buffer and sent on a copy stream (:class:`PinnedPlacer`), so it
    overlaps the previous window's steps. Short final windows are dropped.
    """
    placer = PinnedPlacer(strategy, depth + 2)
    buf = collections.deque()
    it = iter(batches)

    def window():
        stacked, event = buf.popleft()
        placer.ready(event)
        return stacked

    try:
        while True:
            while len(buf) < depth + 1:
                buf.append(placer.place([next(it) for _ in range(num_steps)], stacked=True))
            yield window()
    except StopIteration:
        pass
    while buf:
        yield window()
