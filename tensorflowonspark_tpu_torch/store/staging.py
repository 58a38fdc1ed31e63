"""Prefetch-to-local-disk staging tier for remote shard stores.

A remote shard read has two costs the local path never paid: per-range
request latency and wide-area bandwidth. The stager hides both by
downloading whole shards to executor-local disk *ahead* of the reader —
the same stall-driven discipline the shard read-ahead plane already uses,
steered by the same controller: a
:class:`~tensorflowonspark_tpu_torch.data.autotune.ReadaheadAutotuner` watches
the producer/consumer stall counters and deepens the prefetch window when
the classification says io_bound (consumer starved while shard reads
dominate parse), shallows it when the pipeline demonstrably keeps up.
The depth it chooses is published on the ``store_prefetch_depth`` gauge.

Staged shards commit with the tree-wide durable-publish idiom
(:mod:`tensorflowonspark_tpu_torch.durable`, the commit-discipline rule of
``python -m tosa``): bytes download into a ``tmp.obj-*`` staging
directory, the data file is fsynced, ``MANIFEST.json`` is written last,
one atomic rename publishes, the parent directory entry is fsynced, and
the shard is *adopted* only after ``manifest.verify`` passes on the
published name. Verify runs again on first use of any staged shard this
process did not verify itself (warm reopen after a crash), so a torn
publish — a power cut mid-commit, or the ``store.prefetch_tear`` chaos
site — is rejected, deleted, and the shard is simply re-fetched: the
staging tier can serve cold or serve verified bytes, never garbage.

The staged tier is capacity-bounded (``TOS_PREFETCH_BYTES``): once the
resident bytes exceed the bound, least-recently-used shards are evicted
(``store_prefetch_evictions_total``) and fall back to the remote cold
store on next use — the bottom rung of the tier hierarchy documented in
docs/architecture.md.

Env lanes: ``TOS_PREFETCH_DIR`` (staging root, default
``$TMPDIR/tos-prefetch``), ``TOS_STORE_PREFETCH`` (window depth; ``auto``
default = autotuned, ``0`` disables staging so remote shards stream
cold), ``TOS_PREFETCH_BYTES`` (staged-tier capacity, 0/unset =
unbounded).
"""

import concurrent.futures
import logging
import os
import shutil
import tempfile
import threading
import uuid
import zlib

from tensorflowonspark_tpu_torch import chaos, durable, obs
from tensorflowonspark_tpu_torch.ckpt import manifest

logger = logging.getLogger(__name__)

DIR_ENV = "TOS_PREFETCH_DIR"
DEPTH_ENV = "TOS_STORE_PREFETCH"
BYTES_ENV = "TOS_PREFETCH_BYTES"

_DATA_NAME = "data.bin"
#: background download threads: enough to overlap fetch with consume,
#: few enough that the staging tier never competes with the reader pool
_FETCH_THREADS = 2


def default_root():
    return os.path.join(tempfile.gettempdir(), "tos-prefetch")


def _obj_dirname(path):
    """Filesystem-safe staged-directory name for one remote shard: the
    readable basename plus a crc of the full URL so distinct corpora whose
    shards share basenames cannot collide."""
    base = str(path).rstrip("/").rsplit("/", 1)[-1]
    safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in base)
    return "obj-{}-{:08x}".format(safe[:80], zlib.crc32(str(path).encode()))


def resolve_stager(store, prefetch=None, root=None, capacity_bytes=None):
    """Build the staging tier implied by the knobs: ``prefetch`` (default
    ``$TOS_STORE_PREFETCH`` or ``auto``) of ``0``/``off`` means *no
    stager* — remote shards stream cold through range-GETs — otherwise a
    :class:`PrefetchStager` with a fixed or autotuned window."""
    if prefetch is None:
        prefetch = os.environ.get(DEPTH_ENV, "auto")
    mode = str(prefetch).strip().lower()
    if mode in ("0", "off", "cold", "none", "false"):
        return None
    depth = None if mode == "auto" else max(1, int(mode))
    if root is None:
        root = os.environ.get(DIR_ENV) or default_root()
    if capacity_bytes is None:
        capacity_bytes = int(os.environ.get(BYTES_ENV, "0")) or None
    return PrefetchStager(store, root=root, depth=depth, capacity_bytes=capacity_bytes)


class PrefetchStager:
    """Downloads remote shards to local disk ahead of the reader.

    ``plan(order)`` declares one epoch's shard visit order and warms the
    window; ``fetch(path)`` blocks until ``path`` is staged (foreground
    download on a miss) and returns the local data file the classic loader
    path then reads natively; ``close()`` drains the download pool. All
    shared state is guarded by one lock; downloads run on a small named
    thread pool.
    """

    def __init__(self, store, root=None, depth=None, capacity_bytes=None, clock=None):
        from tensorflowonspark_tpu_torch.data import autotune

        self.store = store
        self.root = os.path.abspath(os.path.expanduser(root or default_root()))
        os.makedirs(self.root, exist_ok=True)
        self.capacity_bytes = capacity_bytes
        self._lock = threading.Lock()
        self._order = []  # current epoch's shard visit order
        self._cursor = 0  # index of the next shard fetch() will ask for
        self._futures = {}  # path -> in-flight download future
        self._verified = set()  # staged dirs verified by THIS process
        self._sizes = {}  # staged dir -> bytes (for the capacity bound)
        self._tick = 0  # monotonic use counter driving LRU eviction
        self._last_use = {}  # staged dir -> tick of last use
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=_FETCH_THREADS, thread_name_prefix="tos-store-prefetch"
        )
        self._hits_c = obs.counter(
            "store_prefetch_hits_total",
            help="shard reads served from the local staged tier",
        )
        self._misses_c = obs.counter(
            "store_prefetch_misses_total",
            help="shard reads that had to wait on (or run) a remote download",
        )
        self._commits_c = obs.counter(
            "store_prefetch_commits_total",
            help="staged shards published and adopted after verify",
        )
        self._rejects_c = obs.counter(
            "store_prefetch_rejects_total",
            help="staged shards rejected by verify-on-read and re-fetched",
        )
        self._evict_c = obs.counter(
            "store_prefetch_evictions_total",
            help="staged shards evicted by the capacity bound",
        )
        self._bytes_g = obs.gauge(
            "store_prefetch_bytes", help="bytes resident in the staged shard tier"
        )
        self._depth_g = obs.gauge(
            "store_prefetch_depth", help="remote shard prefetch window depth"
        )
        if depth is None:
            self._tuner = autotune.ReadaheadAutotuner(
                min_depth=1,
                max_depth=autotune.DEFAULT_MAX_READAHEAD,
                clock=clock,
                gauge=self._depth_g,
            )
            self.depth = 2  # starting window; the stall rule moves it
        else:
            self._tuner = None
            self.depth = max(1, int(depth))
        self._depth_g.set(int(self.depth))
        self._sweep_leftovers()

    # -- lifecycle --------------------------------------------------------------

    def _sweep_leftovers(self):
        """Adopt staged shards left by an earlier process (verify deferred
        to first use) and clear abandoned ``tmp.obj-*`` staging dirs."""
        total = 0
        for name in os.listdir(self.root):
            full = os.path.join(self.root, name)
            if name.startswith("tmp.obj-"):
                shutil.rmtree(full, ignore_errors=True)
            elif name.startswith("obj-") and os.path.isdir(full):
                try:
                    size = os.path.getsize(os.path.join(full, _DATA_NAME))
                except OSError:
                    size = 0
                self._sizes[full] = size
                self._last_use[full] = 0
                total += size
        self._bytes_g.set(float(total))
        # a reopened tier honors the (possibly tightened) capacity bound
        self._evict_over_capacity()

    def close(self):
        """Drain the download pool; staged shards stay on disk (they are
        the warm tier the next run reopens)."""
        with self._lock:
            futures = list(self._futures.values())
            self._futures.clear()
        for f in futures:
            f.cancel()
        self._pool.shutdown(wait=True)

    # -- epoch window -----------------------------------------------------------

    def plan(self, order):
        """Declare one epoch's shard visit order and warm the first
        ``depth`` shards in the background."""
        with self._lock:
            self._order = [str(p) for p in order]
            self._cursor = 0
        self._top_up()

    def _top_up(self):
        """Schedule background downloads for unstaged shards inside the
        window ``[cursor, cursor + depth)``."""
        with self._lock:
            window = self._order[self._cursor : self._cursor + int(self.depth)]
            for path in window:
                final = os.path.join(self.root, _obj_dirname(path))
                if final in self._sizes or path in self._futures:
                    continue
                self._futures[path] = self._pool.submit(self._stage_quiet, path)

    def _stage_quiet(self, path):
        try:
            return self._stage(path)
        except Exception as e:  # background lane: a failed prefetch is a
            # cold read later, never a crashed pipeline
            logger.warning("store prefetch of %s failed: %s", path, e)
            return None

    # -- serving ----------------------------------------------------------------

    def fetch(self, path):
        """Block until ``path`` is staged and verified; returns the local
        data file path, or None when staging failed (caller reads cold).
        Advances the window and ticks the depth autotuner."""
        path = str(path)
        final = os.path.join(self.root, _obj_dirname(path))
        with self._lock:
            try:
                self._cursor = self._order.index(path, self._cursor) + 1
            except ValueError:
                pass
            self._tick += 1
            self._last_use[final] = self._tick
            staged = final in self._sizes
            future = self._futures.get(path)
        if staged and future is None:
            data = self._verify_on_read(final, path)
            if data is not None:
                self._hits_c.inc()
                self._after_fetch()
                return data
            staged = False
        self._misses_c.inc()
        if future is not None:
            data = future.result()
            with self._lock:
                self._futures.pop(path, None)
        else:
            data = self._stage_quiet(path)
        self._after_fetch()
        return data

    def _after_fetch(self):
        if self._tuner is not None:
            target = self._tuner.tick(self.depth)
            if target is not None and target != self.depth:
                logger.info("store prefetch window: %d -> %d", self.depth, target)
                self.depth = target
        self._top_up()

    def _verify_on_read(self, final, path):
        """The staged data file, after the first-use integrity check for
        shards staged by an earlier process. A reject deletes the staged
        dir so the caller re-fetches."""
        with self._lock:
            seen = final in self._verified
        if not seen:
            ok, reason = manifest.verify(final)
            if not ok:
                logger.warning(
                    "store prefetch: rejecting staged %s (%s)", final, reason
                )
                self._rejects_c.inc()
                self._drop(final)
                return None
            with self._lock:
                self._verified.add(final)
        return os.path.join(final, _DATA_NAME)

    # -- staging commit ---------------------------------------------------------

    def _stage(self, path):
        """Download ``path`` and publish it into the staged tier with the
        durable commit idiom: fsync the data file, ``MANIFEST.json`` last,
        atomic rename, parent-directory fsync, adopt only after verify."""
        final = os.path.join(self.root, _obj_dirname(path))
        with self._lock:
            if final in self._sizes and final in self._verified:
                return os.path.join(final, _DATA_NAME)
        stage = os.path.join(self.root, "tmp.obj-{}".format(uuid.uuid4().hex[:8]))
        os.makedirs(stage)
        try:
            with open(os.path.join(stage, _DATA_NAME), "wb") as f:
                nbytes = self.store.fetch(path, f)
                f.flush()
                os.fsync(f.fileno())
            manifest.write_manifest(stage, extra={"source": str(path)})
            if chaos.active and chaos.fire("store.prefetch_tear"):
                # publish a *torn* manifest: the commit marker exists but
                # lies, exactly what a crash mid-publish leaves behind
                mpath = os.path.join(stage, manifest.MANIFEST_NAME)
                with open(mpath, "r+") as mf:
                    mf.truncate(os.path.getsize(mpath) // 2)
            if os.path.exists(final):  # lost a race or replacing a reject
                shutil.rmtree(final, ignore_errors=True)
            os.rename(stage, final)
        except Exception:
            shutil.rmtree(stage, ignore_errors=True)
            raise
        # the rename is only durable once the root's entry table is —
        # without this a power cut can replay the directory with the old
        # (deleted) entry and the verify-on-read contract does the rest
        durable.fsync_dir(self.root)
        ok, reason = manifest.verify(final)
        if not ok:
            logger.warning(
                "store prefetch: published shard failed verify (%s); dropping", reason
            )
            self._rejects_c.inc()
            shutil.rmtree(final, ignore_errors=True)
            return None
        with self._lock:
            self._sizes[final] = int(nbytes)
            self._last_use.setdefault(final, self._tick)
            self._verified.add(final)
            total = sum(self._sizes.values())
        self._commits_c.inc()
        self._bytes_g.set(float(total))
        self._evict_over_capacity()
        return os.path.join(final, _DATA_NAME)

    # -- capacity bound ---------------------------------------------------------

    def _drop(self, final):
        with self._lock:
            self._sizes.pop(final, None)
            self._verified.discard(final)
            self._last_use.pop(final, None)
            total = sum(self._sizes.values())
        shutil.rmtree(final, ignore_errors=True)
        self._bytes_g.set(float(total))

    def _evict_over_capacity(self):
        """Evict least-recently-used staged shards until resident bytes fit
        the capacity bound; evicted shards fall back to the remote cold
        store on next use."""
        if not self.capacity_bytes:
            return
        while True:
            with self._lock:
                total = sum(self._sizes.values())
                if total <= self.capacity_bytes or len(self._sizes) <= 1:
                    return
                victim = min(self._sizes, key=lambda d: self._last_use.get(d, 0))
            logger.info("store prefetch: evicting %s (tier over capacity)", victim)
            self._evict_c.inc()
            self._drop(victim)
