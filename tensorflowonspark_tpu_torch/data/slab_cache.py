"""Cross-epoch decoded-slab cache: decode each record once per job, not once
per epoch.

Epoch 1 decodes every record (native or PIL) and the loader streams the
pixels into shared-memory slab slots; this module persists those decoded
rows so epoch >= 2 — and an elastic relaunch that re-reads the same shard
set — fills slots straight from a page-cached memory map instead of running
JPEG decode at all. A cache hit "leases a slot without touching a worker":
the loader writes the cached row parent-side and the decode plane never
sees the task.

Keying: a cache directory is scoped by the *decode-parameter fingerprint*
(``parse_fn.cache_key`` — train/eval, image size, augmentation seed, ...)
and rows inside it are keyed by the record's crc32. Same bytes + same
parameters ⇒ same pixels in every decode mode (the byte-identical stream
contract pinned by tests/test_loader_pipeline.py), so a cached row is
interchangeable with a fresh decode.

Durability uses the checkpoint commit pattern
(:mod:`tensorflowonspark_tpu_torch.ckpt.manifest`): rows append to a staging
directory (``tmp.gen-*``), and :meth:`SlabCache.commit` seals it — fsync
the data file, write ``index.json``, write ``MANIFEST.json`` last, one
atomic rename to ``gen-<n>``. A generation is *adopted* only after
``manifest.verify`` passes on the published directory, so a torn commit
(crash mid-publish, or the ``data.cache_tear`` chaos site) is rejected and
its records simply decode again — the cache can serve stale-free or serve
nothing, never serve garbage.

Observability (rows in docs/architecture.md's Metrics inventory):

==================================  =======================================
metric                              meaning
==================================  =======================================
``decode_cache_hits_total``         slot fills served from the cache (any tier)
``decode_cache_rejects_total``      generations rejected by cheap-verify
``decode_cache_bytes``              bytes resident in committed generations
``tier_ram_hits_total``             hits served from the RAM tier
``tier_disk_hits_total``            hits served from a disk generation
``tier_promotions_total``           rows copied disk → RAM on a disk hit
``tier_demotions_total``            rows dropped from RAM by its LRU bound
``tier_evictions_total``            generations evicted by the disk bound
``tier_ram_bytes``                  bytes resident in the RAM tier
==================================  =======================================

Tier hierarchy (docs/architecture.md "Storage tiering"): RAM rows →
local-disk decoded generations → whatever cold store the loader reads
shards from (local filesystem, or a remote ``ShardStore`` behind the
prefetch stager). Both cache tiers are capacity-bounded — the RAM tier
drops least-recently-used rows (they stay on disk), the disk tier evicts
whole least-recently-used *generations* (their records decode again from
the cold store) — so the cache degrades to slower tiers, never to
unbounded growth.

Single-threaded by design: only the loader's producer thread touches a
``SlabCache`` (lookup/put/commit all happen on the slot-assignment path),
mirroring how the decode plane's lease protocol is driven from one thread.
"""

import collections
import json
import logging
import os
import shutil
import uuid

import numpy as np

from tensorflowonspark_tpu_torch import chaos, durable, obs
from tensorflowonspark_tpu_torch.ckpt import manifest

logger = logging.getLogger(__name__)

#: env default for the loader's ``slab_cache_dir`` knob
ENV_VAR = "TOS_SLAB_CACHE_DIR"
#: capacity bound (bytes) for the committed disk generations; 0/unset =
#: unbounded (the pre-tiering behavior)
BYTES_ENV_VAR = "TOS_SLAB_CACHE_BYTES"
#: capacity bound (bytes) for the RAM promotion tier
RAM_ENV_VAR = "TOS_SLAB_RAM_BYTES"
#: default RAM tier size: big enough to hold a benchmark epoch's hot rows,
#: small next to a training host's memory
DEFAULT_RAM_BYTES = 64 * 1024 * 1024

_DATA_NAME = "data.bin"
_INDEX_NAME = "index.json"


def resolve_dir(slab_cache_dir):
    """Normalize the loader knob: ``None`` reads :data:`ENV_VAR` (default
    off), empty string means off. Returns a path or None."""
    if slab_cache_dir is None:
        slab_cache_dir = os.environ.get(ENV_VAR, "")
    return slab_cache_dir or None


def _fingerprint(cache_key):
    """Filesystem-safe directory name for one decode-parameter set: a
    readable prefix plus a crc to keep distinct keys from colliding after
    sanitization."""
    import zlib

    safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in str(cache_key))
    return "{}-{:08x}".format(safe[:80], zlib.crc32(str(cache_key).encode()))


class SlabCache:
    """Persistent decoded-row store for one ``(decode params, geometry)``.

    ``lookup(key)`` returns ``(pixels, label)`` from a committed generation
    (zero-copy view of a memory map) or None; ``put(key, pixels, label)``
    stages a freshly decoded row; ``commit()`` seals the staged rows into a
    new generation (call at epoch boundaries). Rows staged but never
    committed are discarded on :meth:`close` — exactly the checkpoint
    staging-dir contract.
    """

    def __init__(self, root, cache_key, shape, dtype, max_bytes=None, ram_bytes=None):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        if self.dtype.hasobject:
            raise ValueError("slab cache rows must be a plain binary dtype")
        self.dir = os.path.join(
            os.path.abspath(os.path.expanduser(root)), _fingerprint(cache_key)
        )
        os.makedirs(self.dir, exist_ok=True)
        if max_bytes is None:
            max_bytes = int(os.environ.get(BYTES_ENV_VAR, "0")) or None
        if ram_bytes is None:
            ram_bytes = int(os.environ.get(RAM_ENV_VAR, str(DEFAULT_RAM_BYTES)))
        self.max_bytes = max_bytes
        self.ram_bytes = max(0, int(ram_bytes))
        self._row_bytes = int(np.prod(self.shape)) * self.dtype.itemsize
        # committed generations: (memmap, {key: (row, label)}), tombstoned
        # to None on eviction so _index map indices stay stable
        self._maps = []
        self._index = {}  # key -> (map idx, row) merged across generations
        self._staging = None  # (dir, open data file, {key: (row, label)})
        self._gen_dirs = {}  # map idx -> published directory (for eviction)
        self._gen_use = {}  # map idx -> tick of last hit (LRU eviction order)
        self._tick = 0
        self._ram = collections.OrderedDict()  # key -> (row copy, label), LRU
        self._hits_c = obs.counter(
            "decode_cache_hits_total", help="slot fills served from the decoded-slab cache"
        )
        self._rejects_c = obs.counter(
            "decode_cache_rejects_total",
            help="decoded-slab cache generations rejected by cheap-verify",
        )
        self._bytes_g = obs.gauge(
            "decode_cache_bytes", help="bytes resident in committed decoded-slab generations"
        )
        self._ram_hits_c = obs.counter(
            "tier_ram_hits_total", help="slab-cache hits served from the RAM tier"
        )
        self._disk_hits_c = obs.counter(
            "tier_disk_hits_total", help="slab-cache hits served from a disk generation"
        )
        self._promote_c = obs.counter(
            "tier_promotions_total", help="slab-cache rows promoted disk → RAM"
        )
        self._demote_c = obs.counter(
            "tier_demotions_total", help="slab-cache rows demoted out of the RAM tier"
        )
        self._evict_c = obs.counter(
            "tier_evictions_total",
            help="slab-cache generations evicted by the disk capacity bound",
        )
        self._ram_bytes_g = obs.gauge(
            "tier_ram_bytes", help="bytes resident in the slab-cache RAM tier"
        )
        self._load_generations()

    # -- read side --------------------------------------------------------------

    def _load_generations(self):
        for name in sorted(os.listdir(self.dir)):
            gen = os.path.join(self.dir, name)
            if not name.startswith("gen-") or not os.path.isdir(gen):
                continue
            ok, reason = manifest.verify(gen)
            if not ok or manifest.read_manifest(gen) is None:
                logger.warning("slab cache: rejecting %s (%s)", gen, reason if not ok else "no manifest")
                self._rejects_c.inc()
                shutil.rmtree(gen, ignore_errors=True)
                continue
            try:
                with open(os.path.join(gen, _INDEX_NAME)) as f:
                    meta = json.load(f)
                if tuple(meta["shape"]) != self.shape or meta["dtype"] != self.dtype.str:
                    logger.warning("slab cache: %s has geometry %s/%s, want %s/%s; skipping",
                                   gen, meta.get("shape"), meta.get("dtype"),
                                   list(self.shape), self.dtype.str)
                    continue
                rows = len(meta["keys"])
                mm = np.memmap(os.path.join(gen, _DATA_NAME), mode="r",
                               dtype=self.dtype, shape=(rows,) + self.shape)
            except (OSError, ValueError, KeyError) as e:
                logger.warning("slab cache: rejecting %s (%s)", gen, e)
                self._rejects_c.inc()
                shutil.rmtree(gen, ignore_errors=True)
                continue
            idx = len(self._maps)
            table = {}
            for row, (key, label) in enumerate(zip(meta["keys"], meta["labels"])):
                table[int(key)] = (row, int(label))
                self._index[int(key)] = (idx, row)
            self._maps.append((mm, table))
            self._gen_dirs[idx] = gen
            self._gen_use[idx] = 0
        self._evict_over_capacity()
        self._bytes_g.set(float(self._disk_bytes()))
        if self._index:
            logger.info("slab cache: %d row(s) across %d generation(s) at %s",
                        len(self._index), len(self._maps), self.dir)

    def _next_gen_dir(self):
        """First unused ``gen-<n>`` name. Collisions with a concurrent
        publisher surface as an OSError from :func:`os.rename` (rename onto
        an existing non-empty dir fails), which commit() treats as a reject
        — never as silent corruption."""
        taken = set()
        for name in os.listdir(self.dir):
            if name.startswith("gen-"):
                try:
                    taken.add(int(name[4:]))
                except ValueError:
                    pass
        n = 0
        while n in taken:
            n += 1
        return os.path.join(self.dir, "gen-{:06d}".format(n))

    def lookup(self, key):
        """``(pixels, label)`` for a record crc, or None — RAM tier first,
        then the disk generations (a disk hit promotes the row into RAM).
        The pixels are a read-only view (memmap) or the promoted copy —
        copy-on-assign into the slab slot is the single copy on either hit
        path."""
        key = int(key)
        hit = self._ram.get(key)
        if hit is not None:
            self._ram.move_to_end(key)
            self._hits_c.inc()
            self._ram_hits_c.inc()
            return hit
        loc = self._index.get(key)
        if loc is None:
            return None
        mm, table = self._maps[loc[0]]
        row, label = table[key]
        self._tick += 1
        self._gen_use[loc[0]] = self._tick
        self._hits_c.inc()
        self._disk_hits_c.inc()
        self._promote(key, mm[row], label)
        return mm[row], label

    def _promote(self, key, pixels, label):
        """Copy one disk-hit row into the RAM tier, demoting LRU rows past
        the RAM bound (they stay on disk — demotion is a free drop)."""
        if self._row_bytes > self.ram_bytes:
            return
        self._ram[key] = (np.array(pixels), int(label))
        self._ram.move_to_end(key)
        self._promote_c.inc()
        while len(self._ram) * self._row_bytes > self.ram_bytes:
            self._ram.popitem(last=False)
            self._demote_c.inc()
        self._ram_bytes_g.set(float(len(self._ram) * self._row_bytes))

    def __len__(self):
        return len(self._index)

    # -- write side -------------------------------------------------------------

    def put(self, key, pixels, label):
        """Stage one decoded row (no-op when the key is already cached or
        already staged). ``pixels`` must match the cache geometry."""
        key = int(key)
        if key in self._index:
            return
        if self._staging is None:
            stage = os.path.join(self.dir, "tmp.gen-{}".format(uuid.uuid4().hex[:8]))
            os.makedirs(stage)
            self._staging = (stage, open(os.path.join(stage, _DATA_NAME), "wb"), {})
        stage, data_f, staged = self._staging
        if key in staged:
            return
        arr = np.ascontiguousarray(pixels, dtype=self.dtype)
        if arr.shape != self.shape:
            raise ValueError("row shape {} != cache geometry {}".format(arr.shape, self.shape))
        data_f.write(arr.tobytes())
        staged[key] = (len(staged), int(label))

    def commit(self):
        """Seal the staged rows into a committed generation: fsync data,
        ``index.json``, ``MANIFEST.json`` last, atomic rename, then adopt
        the generation only after cheap-verify passes on the published
        directory (a torn publish is rejected and deleted — its records
        decode again). Returns the number of rows committed, 0 when nothing
        was staged."""
        if self._staging is None:
            return 0
        stage, data_f, staged = self._staging
        self._staging = None
        if not staged:
            data_f.close()
            shutil.rmtree(stage, ignore_errors=True)
            return 0
        data_f.flush()
        os.fsync(data_f.fileno())
        data_f.close()
        keys = sorted(staged, key=lambda k: staged[k][0])
        meta = {
            "shape": list(self.shape),
            "dtype": self.dtype.str,
            "keys": keys,
            "labels": [staged[k][1] for k in keys],
        }
        with open(os.path.join(stage, _INDEX_NAME), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        manifest.write_manifest(stage)
        if chaos.active and chaos.fire("data.cache_tear"):
            # publish a *torn* manifest: the commit marker exists but lies,
            # exactly what a crash between manifest write and fsync leaves
            mpath = os.path.join(stage, manifest.MANIFEST_NAME)
            with open(mpath, "r+") as f:
                f.truncate(os.path.getsize(mpath) // 2)
        final = self._next_gen_dir()
        try:
            os.rename(stage, final)
        except OSError as e:
            logger.warning("slab cache: publish rename failed (%s); dropping", e)
            self._rejects_c.inc()
            shutil.rmtree(stage, ignore_errors=True)
            return 0
        # a generation that vanishes with a power cut is merely a cold
        # cache, but a half-visible one would be re-staged under a new
        # name while the old entry lingers — make the publish durable
        durable.fsync_dir(os.path.dirname(final))
        ok, reason = manifest.verify(final)
        if not ok:
            logger.warning("slab cache: published generation failed verify (%s); dropping", reason)
            self._rejects_c.inc()
            shutil.rmtree(final, ignore_errors=True)
            return 0
        rows = len(keys)
        mm = np.memmap(os.path.join(final, _DATA_NAME), mode="r",
                       dtype=self.dtype, shape=(rows,) + self.shape)
        idx = len(self._maps)
        table = {}
        for row, key in enumerate(keys):
            table[key] = (row, staged[key][1])
            self._index[key] = (idx, row)
        self._maps.append((mm, table))
        self._gen_dirs[idx] = final
        self._tick += 1
        self._gen_use[idx] = self._tick
        self._evict_over_capacity(keep=idx)
        self._bytes_g.set(float(self._disk_bytes()))
        logger.info("slab cache: committed %d row(s) (%d total) at %s", rows, len(self._index), self.dir)
        return rows

    # -- capacity bound ---------------------------------------------------------

    def _disk_bytes(self):
        return sum(entry[0].nbytes for entry in self._maps if entry is not None)

    def _evict_over_capacity(self, keep=None):
        """Evict least-recently-used generations until the committed bytes
        fit ``max_bytes`` (never the just-committed ``keep``). An evicted
        generation is tombstoned — map indices in ``_index`` stay stable —
        and its records simply decode again from the cold store."""
        if not self.max_bytes:
            return
        while self._disk_bytes() > self.max_bytes:
            live = [
                i for i, entry in enumerate(self._maps)
                if entry is not None and i != keep
            ]
            if not live:
                return
            victim = min(live, key=lambda i: self._gen_use.get(i, 0))
            mm, table = self._maps[victim]
            self._maps[victim] = None
            for key in table:
                self._index.pop(key, None)
                self._ram.pop(key, None)
            self._ram_bytes_g.set(float(len(self._ram) * self._row_bytes))
            gen = self._gen_dirs.pop(victim, None)
            self._gen_use.pop(victim, None)
            self._evict_c.inc()
            logger.info("slab cache: evicting generation %s (disk tier over capacity)", gen)
            del mm
            if gen:
                shutil.rmtree(gen, ignore_errors=True)
            self._bytes_g.set(float(self._disk_bytes()))

    def close(self):
        """Release memory maps and discard any uncommitted staging dir."""
        if self._staging is not None:
            stage, data_f, _staged = self._staging
            self._staging = None
            try:
                data_f.close()
            except OSError:
                pass
            shutil.rmtree(stage, ignore_errors=True)
        self._maps = []
        self._index = {}
        self._ram.clear()
        self._gen_dirs = {}
        self._gen_use = {}
