"""``ShardStore`` — the ABI every shard source implements.

The contract mirrors what ``native_io.read_records_chunked`` has always
exposed to the loader, generalized off the local filesystem:

- ``list_shards(root)`` — the shard files under a corpus root, in the
  **deterministic order the sharding contract depends on** (sorted by
  shard basename, then full path — identical for a local directory and a
  remote listing of the same corpus, so ``shard_files`` assigns the same
  shards to the same workers either way).
- ``stat(path)`` — ``{"size": bytes, ...}`` without reading the object.
- ``open(path) → ChunkReader`` — ``read_chunk(n)`` / ``close()``, the
  chunked-read contract of :mod:`~tensorflowonspark_tpu_torch.store.framing`.
- ``read_records_chunked(path)`` — the loader-facing generator built from
  the three primitives via :func:`framing.iter_chunks` (retried open,
  never-retried stream, close on every exit).
- ``fingerprint()`` — a short backend id (recorded by bench runs so a
  measured number names the store it was measured against).

Concrete stores: :class:`~tensorflowonspark_tpu_torch.store.local.LocalStore`
(today's filesystem path, native fast path preserved) and
:class:`~tensorflowonspark_tpu_torch.store.http.HTTPStore` (range-GET chunked
reads; GCS/S3 ride the same code path via endpoint adapters).
"""

import threading

from tensorflowonspark_tpu_torch.store import framing


def shard_sort_key(path):
    """Order shards by basename first, full path second: a local glob and
    a remote URL listing of the same corpus sort identically, so worker
    shard assignment cannot depend on where the corpus lives."""
    p = str(path).rstrip("/")
    return (p.rsplit("/", 1)[-1], p)


class ShardStore:
    """ABI; see the module docstring. Subclasses set :attr:`retry` to the
    ``resilience.RetryPolicy`` their ``open`` is retried under."""

    retry = None

    def handles(self, path):
        """True when ``path`` names an object in this store."""
        raise NotImplementedError

    def list_shards(self, root):
        raise NotImplementedError

    def stat(self, path):
        raise NotImplementedError

    def open(self, path, verify_crc=True):
        raise NotImplementedError

    def fingerprint(self):
        raise NotImplementedError

    def fetch(self, path, out_f):
        """Copy the raw object bytes to the open binary file ``out_f`` (the
        staging tier's download primitive). Returns the byte count."""
        raise NotImplementedError

    def read_records_chunked(self, path, chunk_records=1024, verify_crc=True):
        """Generator of record-chunk lists — the loader's streaming ABI."""
        note_backend(self.fingerprint())
        return framing.iter_chunks(
            lambda: self.open(path, verify_crc=verify_crc),
            chunk_records,
            retry=self.retry,
        )

    def read_records(self, path, verify_crc=True):
        """All record payloads of one shard as a single list (bulk path)."""
        out = []
        for chunk in self.read_records_chunked(path, 4096, verify_crc=verify_crc):
            out.extend(chunk)
        return out


# -- backend fingerprint (for bench provenance) --------------------------------

_fingerprint_lock = threading.Lock()
_active_fingerprint = "local"


def note_backend(fingerprint):
    """Record the most recently used store backend; bench runs embed it in
    their stalls block so a measured rate names its byte source."""
    global _active_fingerprint
    with _fingerprint_lock:
        _active_fingerprint = str(fingerprint)


def active_fingerprint():
    with _fingerprint_lock:
        return _active_fingerprint
