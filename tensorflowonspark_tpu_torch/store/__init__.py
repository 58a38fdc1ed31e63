"""``store/`` — shard sources behind the read-ahead plane.

The loader's byte source, generalized off the local filesystem:

- :mod:`~tensorflowonspark_tpu_torch.store.framing` — the one TFRecord
  framing/chunk implementation (``tfrecord`` and ``native_io`` both
  delegate here).
- :mod:`~tensorflowonspark_tpu_torch.store.base` — the :class:`ShardStore` ABI
  (``list_shards`` / ``stat`` / ``open → read_chunk → close``).
- :mod:`~tensorflowonspark_tpu_torch.store.local` — today's filesystem path,
  native fast path preserved.
- :mod:`~tensorflowonspark_tpu_torch.store.http` — range-GET remote reads
  (plain HTTP, GCS/S3 via endpoint adapters) under a retry policy.
- :mod:`~tensorflowonspark_tpu_torch.store.staging` — prefetch-to-local-disk
  tier steered by the read-ahead autotuner (imported lazily by consumers:
  it pulls in ``data.autotune``, which the leaf modules here must not).
"""

from tensorflowonspark_tpu_torch.store import base, framing, http, local
from tensorflowonspark_tpu_torch.store.base import ShardStore, active_fingerprint, shard_sort_key
from tensorflowonspark_tpu_torch.store.http import GCSAdapter, HTTPStore, IndexHtmlAdapter, S3Adapter, resolve_store
from tensorflowonspark_tpu_torch.store.local import LocalStore

__all__ = [
    "ShardStore",
    "LocalStore",
    "HTTPStore",
    "IndexHtmlAdapter",
    "GCSAdapter",
    "S3Adapter",
    "active_fingerprint",
    "resolve_store",
    "shard_sort_key",
    "base",
    "framing",
    "http",
    "local",
]
