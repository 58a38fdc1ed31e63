"""``LocalStore`` — the filesystem shard source behind the store ABI.

Wraps today's local read path without changing it: ``open`` hands back the
native streaming reader (``csrc/tfrecord_io.cc`` ``tfr_stream_next``)
when the library carries the streaming API, and the shared Python framing
(:mod:`~tensorflowonspark_tpu_torch.store.framing`) otherwise — the same
native-fast-path-with-portable-fallback split the loader always made,
now expressed once behind ``ShardStore``.
"""

import os
import shutil

from tensorflowonspark_tpu_torch.store import base, framing


def strip_file_scheme(path):
    path = str(path)
    if path.startswith("file://"):
        return path[len("file://"):]
    return path


class LocalStore(base.ShardStore):
    """Shard source for executor-local (or mounted) filesystem paths."""

    #: opens are retried by the callers that always did (the loader's
    #: ``SHARD_READ_RETRY``, ``native_io.READ_RETRY``); the store itself
    #: adds no second retry layer on the local path
    retry = None

    def handles(self, path):
        path = str(path)
        return "://" not in path or path.startswith("file://")

    def list_shards(self, root):
        from tensorflowonspark_tpu_torch import tfrecord

        root = strip_file_scheme(root)
        names = [n for n in os.listdir(root) if tfrecord._is_shard_name(n)]
        return sorted(
            (os.path.join(root, n) for n in names), key=base.shard_sort_key
        )

    def stat(self, path):
        st = os.stat(strip_file_scheme(path))
        return {"size": int(st.st_size), "mtime": float(st.st_mtime)}

    def open(self, path, verify_crc=True):
        from tensorflowonspark_tpu_torch import native_io

        path = strip_file_scheme(path)
        if native_io.stream_available():
            return native_io.open_chunk_reader(path, verify_crc=verify_crc)
        return framing.FramedChunkReader(
            open(path, "rb"), path, verify_crc=verify_crc
        )

    def fetch(self, path, out_f):
        path = strip_file_scheme(path)
        with open(path, "rb") as src:
            shutil.copyfileobj(src, out_f)
        return os.path.getsize(path)

    def fingerprint(self):
        return "local"
