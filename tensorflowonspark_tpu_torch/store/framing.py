"""The one TFRecord framing/chunk implementation behind every shard source.

Before the store subsystem existed the tree carried two copies of the
chunked-read loop — ``tfrecord.read_records_chunked`` (pure-Python framing,
accumulate-into-lists) and ``native_io.read_records_chunked`` (the C
``tfr_stream_open/next/close`` walk) — with the open-retry, clean-EOF and
close-on-teardown semantics duplicated in each. This module is the single
copy both now delegate to:

- :func:`masked_crc` / :func:`read_framed` — THE Python framing loop
  (length + masked-crc32c per record, tensorflow record_writer.h wire
  format), over any file-like object: a local file, an fsspec handle, or a
  remote store's ranged reader.
- :class:`ChunkReader` — the ``open → read_chunk → close`` contract every
  shard source speaks (the ABI :class:`~tensorflowonspark_tpu_torch.store.base.
  ShardStore` exposes, mirroring what ``tfr_stream_next`` always did).
- :func:`iter_chunks` — THE chunk loop: retried open, ``read_chunk`` until
  an empty chunk (clean EOF), close on every exit path. Mid-stream errors
  are never retried — the stream position is gone and corrupt bytes don't
  heal — exactly the contract both former copies enforced separately.

Leaf module: imports nothing from the package, so ``tfrecord`` and the
stores can build on it without an import cycle. The crc32c comes
from ``google_crc32c`` where it is installed and from a table-driven Python
version otherwise (a GPU host need not have the package; the records the
port writes there are small).
"""

import struct

try:
    import google_crc32c
except ImportError:  # the Python version below stands in
    google_crc32c = None

_MASK_DELTA = 0xA282EAD8


def _crc32c_table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1  # reflected Castagnoli polynomial
        table.append(c)
    return table


_CRC32C_TABLE = _crc32c_table()


def crc32c(data):
    """CRC-32C (Castagnoli) of ``data``."""
    if google_crc32c is not None:
        return int.from_bytes(google_crc32c.Checksum(bytes(data)).digest(), "big")
    crc, table = 0xFFFFFFFF, _CRC32C_TABLE
    for byte in bytes(data):
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data):
    """Masked crc32c of ``data`` (tensorflow record_writer.h masking)."""
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF)


def read_framed(f, name, verify_crc=True):
    """Yield raw record payloads from an open TFRecord byte stream ``f``.

    ``name`` labels errors (the path or URL the bytes came from). Raises
    ``IOError`` on truncation or CRC mismatch — the caller decides whether
    that is retryable (an open is; a half-consumed stream is not).
    """
    while True:
        header = f.read(8)
        if not header:
            return
        if len(header) != 8:
            raise IOError("truncated TFRecord length header in {}".format(name))
        (length,) = struct.unpack("<Q", header)
        len_crc_b = f.read(4)
        if len(len_crc_b) != 4:
            raise IOError("truncated TFRecord length crc in {}".format(name))
        (len_crc,) = struct.unpack("<I", len_crc_b)
        if verify_crc and masked_crc(header) != len_crc:
            raise IOError("corrupt TFRecord length crc in {}".format(name))
        data = f.read(length)
        if len(data) != length:
            raise IOError("truncated TFRecord payload in {}".format(name))
        data_crc_b = f.read(4)
        if len(data_crc_b) != 4:
            raise IOError("truncated TFRecord payload crc in {}".format(name))
        (data_crc,) = struct.unpack("<I", data_crc_b)
        if verify_crc and masked_crc(data) != data_crc:
            raise IOError("corrupt TFRecord payload crc in {}".format(name))
        yield data


class ChunkReader:
    """The chunked-read contract of one open shard.

    ``read_chunk(max_records)`` returns up to ``max_records`` record
    payloads as a list — an empty list means clean EOF. ``close()``
    releases the underlying handle; it must be idempotent. Concrete
    reader in the port: :class:`FramedChunkReader` over any byte source.
    """

    def read_chunk(self, max_records):
        raise NotImplementedError

    def close(self):
        raise NotImplementedError


class FramedChunkReader(ChunkReader):
    """Python-codec :class:`ChunkReader` over an open byte stream: the
    framing loop of :func:`read_framed` chunked into lists. Owns ``f`` —
    ``close()`` closes it."""

    def __init__(self, f, name, verify_crc=True):
        self._f = f
        self._records = read_framed(f, name, verify_crc=verify_crc)

    def read_chunk(self, max_records):
        chunk = []
        for rec in self._records:
            chunk.append(rec)
            if len(chunk) >= max_records:
                break
        return chunk

    def close(self):
        f, self._f = self._f, None
        if f is not None:
            f.close()


def iter_chunks(open_reader, chunk_records, retry=None):
    """Generator of record-chunk lists over the ``open → read_chunk →
    close`` contract.

    ``open_reader()`` returns a :class:`ChunkReader`; when ``retry`` (a
    ``resilience.RetryPolicy``) is given the *open* is retried under it —
    transient filesystem/network errors heal on a re-open. ``read_chunk``
    is never retried: past the open, the stream position is gone. The
    reader is closed on every exit path (clean EOF, error, or an abandoned
    generator torn down by GC).
    """
    reader = retry.call(open_reader) if retry is not None else open_reader()
    try:
        while True:
            chunk = reader.read_chunk(int(chunk_records))
            if not chunk:
                return
            yield chunk
    finally:
        reader.close()
