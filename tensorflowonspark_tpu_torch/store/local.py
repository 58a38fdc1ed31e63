"""``LocalStore`` — the filesystem shard source behind the store ABI.

``open`` hands back the shared Python framing reader
(:mod:`~tensorflowonspark_tpu_torch.store.framing`); the JAX package's
native streaming reader comes with the image-plane slice.
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

    #: opens are retried by the loader (``SHARD_READ_RETRY``); the store
    #: itself adds no second retry layer on the local path
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
        path = strip_file_scheme(path)
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
