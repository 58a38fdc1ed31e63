"""``store/`` — shard sources behind the read-ahead plane.

The loader's byte source, generalized off the local filesystem:

- :mod:`~tensorflowonspark_tpu_torch.store.framing` — the one TFRecord
  framing/chunk implementation (``tfrecord`` delegates here).
- :mod:`~tensorflowonspark_tpu_torch.store.base` — the :class:`ShardStore` ABI
  (``list_shards`` / ``stat`` / ``open → read_chunk → close``).
- :mod:`~tensorflowonspark_tpu_torch.store.local` — the filesystem path.

The JAX package's remote stores (``http``: HTTP, GCS, S3) and its
prefetch-to-local-disk ``staging`` tier come with the image-plane slice.
"""

from tensorflowonspark_tpu_torch.store import base, framing, local
from tensorflowonspark_tpu_torch.store.base import ShardStore, active_fingerprint, shard_sort_key
from tensorflowonspark_tpu_torch.store.local import LocalStore

__all__ = [
    "ShardStore",
    "LocalStore",
    "active_fingerprint",
    "shard_sort_key",
    "base",
    "framing",
    "local",
]
