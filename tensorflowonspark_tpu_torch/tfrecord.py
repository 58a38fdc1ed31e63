"""TFRecord file IO + tf.train.Example wire format, dependency-free.

The reference delegated TFRecord IO to a prebuilt Hadoop InputFormat jar
(/root/reference/lib/tensorflow-hadoop-1.0-SNAPSHOT.jar, driven by
dfutil.py:39,63) and the Example proto to TensorFlow. Here both are
implemented directly: the TFRecord framing (length + masked-crc32c records)
and a minimal protobuf codec for the fixed ``Example`` schema — so the TPU
framework reads/writes the interchange format without a TensorFlow or JVM
dependency.

The JAX package binds a C++ twin of the read path
(``native/tfrecord_io.cc``); the port reads through this module's portable
codec only, and the native reader comes with the image-plane slice.

Remote filesystems: paths with a URI scheme (``gs://``, ``hdfs://``,
``s3://``, ``memory://``, ``file://``) are routed through fsspec — the
replacement for the reference's Hadoop-FS-by-way-of-the-jar reach
(reference dfutil.py:39-41,63-65).

Wire format reference: tensorflow/core/lib/io/record_writer.h (framing) and
tensorflow/core/example/example.proto, feature.proto (schema).
"""

import os
import struct

from tensorflowonspark_tpu_torch.store import framing

# -- filesystem routing (local fast path; fsspec for URI schemes) -------------


def is_uri(path):
    return "://" in str(path)


def _fs(path):
    import fsspec

    fs, _token, paths = fsspec.get_fs_token_paths(path)
    return fs, paths[0]


def open_file(path, mode="rb"):
    """Open a local path or any fsspec URI."""
    if is_uri(path):
        fs, p = _fs(path)
        return fs.open(p, mode)
    return open(path, mode)


def makedirs(path):
    if is_uri(path):
        fs, p = _fs(path)
        fs.makedirs(p, exist_ok=True)
    else:
        os.makedirs(path, exist_ok=True)


def rename(src, dst):
    """Same-filesystem rename (the shard commit step).

    Local paths get a true atomic ``os.replace``. On fsspec URIs ``mv`` is
    copy+delete on object stores; if it refuses because the destination
    already exists, a racing speculative/retried committer won — its shard
    is equivalent (same deterministic partition), so the existing file is
    kept and the temp file dropped. The existing destination is never
    deleted first: that would open a window where a committed shard is gone
    and no task remains to rewrite it."""
    if is_uri(src):
        fs, s = _fs(src)
        _fs2, d = _fs(dst)
        try:
            fs.mv(s, d)
        except Exception:
            if not fs.exists(d):
                raise
            try:
                fs.rm(s)
            except Exception:
                pass  # stray temp file; harmless to shard listing
    else:
        os.replace(src, dst)

# -- TFRecord framing ----------------------------------------------------------
# The read-side framing loop lives in store/framing.py (one copy shared with
# the shard stores); this module keeps the write path and the open_file
# routing that covers fsspec URIs.

_MASK_DELTA = framing._MASK_DELTA
_masked_crc = framing.masked_crc


class TFRecordWriter:
    def __init__(self, path):
        self._f = open_file(path, "wb")

    def write(self, record):
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path, verify_crc=True):
    """Yield raw record bytes from a TFRecord file (local or fsspec URI)."""
    with open_file(path, "rb") as f:
        yield from framing.read_framed(f, path, verify_crc=verify_crc)


def read_records_chunked(path, chunk_records=1024, verify_crc=True):
    """Yield lists of up to ``chunk_records`` raw records — the streaming
    twin of :func:`read_records`: the loader's chunked path (this one also
    covers fsspec URIs)."""
    return framing.iter_chunks(
        lambda: framing.FramedChunkReader(
            open_file(path, "rb"), path, verify_crc=verify_crc
        ),
        chunk_records,
    )


# -- minimal protobuf wire codec ----------------------------------------------


def _varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf, pos):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field, wire_type):
    return _varint((field << 3) | wire_type)


def _len_delimited(field, payload):
    return _tag(field, 2) + _varint(len(payload)) + payload


# -- Example proto -------------------------------------------------------------


def encode_feature(values):
    """One tf.train.Feature: list of bytes → BytesList, ints → Int64List
    (packed varints), floats → FloatList (packed fixed32)."""
    if not values:
        return b""
    v0 = values[0]
    if isinstance(v0, (bytes, bytearray, str)):
        payload = b"".join(
            _len_delimited(1, v if isinstance(v, bytes) else str(v).encode("utf-8"))
            for v in values
        )
        return _len_delimited(1, payload)  # Feature.bytes_list
    if isinstance(v0, (bool,)) or isinstance(v0, int):
        packed = b"".join(_varint(v & 0xFFFFFFFFFFFFFFFF) for v in values)
        return _len_delimited(3, _len_delimited(1, packed))  # Feature.int64_list
    if isinstance(v0, float):
        packed = struct.pack("<{}f".format(len(values)), *values)
        return _len_delimited(2, _len_delimited(1, packed))  # Feature.float_list
    raise TypeError("unsupported feature value type {!r}".format(type(v0)))


def encode_example(features):
    """``{name: list-of-values}`` → serialized tf.train.Example bytes."""
    entries = b""
    for name in sorted(features):
        values = features[name]
        if not isinstance(values, (list, tuple)):
            values = [values]
        entry = _len_delimited(1, name.encode("utf-8")) + _len_delimited(
            2, encode_feature(list(values))
        )
        entries += _len_delimited(1, entry)  # Features.feature map entry
    return _len_delimited(1, entries)  # Example.features


def _decode_packed_varints(buf):
    out, pos = [], 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        if v >= 1 << 63:  # two's-complement negative int64
            v -= 1 << 64
        out.append(v)
    return out


def _decode_feature(buf):
    """Feature bytes → ('bytes'|'int64'|'float', values)."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        assert wt == 2, "unexpected wire type in Feature"
        length, pos = _read_varint(buf, pos)
        inner = buf[pos : pos + length]
        pos += length
        if field == 1:  # BytesList
            vals, ipos = [], 0
            while ipos < len(inner):
                t, ipos = _read_varint(inner, ipos)
                assert t >> 3 == 1
                ln, ipos = _read_varint(inner, ipos)
                vals.append(bytes(inner[ipos : ipos + ln]))
                ipos += ln
            return "bytes", vals
        if field == 2:  # FloatList
            vals, ipos = [], 0
            while ipos < len(inner):
                t, ipos = _read_varint(inner, ipos)
                assert t >> 3 == 1
                if t & 7 == 2:  # packed
                    ln, ipos = _read_varint(inner, ipos)
                    vals.extend(
                        struct.unpack("<{}f".format(ln // 4), inner[ipos : ipos + ln])
                    )
                    ipos += ln
                else:  # unpacked fixed32
                    vals.append(struct.unpack("<f", inner[ipos : ipos + 4])[0])
                    ipos += 4
            return "float", vals
        if field == 3:  # Int64List
            vals, ipos = [], 0
            while ipos < len(inner):
                t, ipos = _read_varint(inner, ipos)
                assert t >> 3 == 1
                if t & 7 == 2:  # packed
                    ln, ipos = _read_varint(inner, ipos)
                    vals.extend(_decode_packed_varints(inner[ipos : ipos + ln]))
                    ipos += ln
                else:  # unpacked varint
                    v, ipos = _read_varint(inner, ipos)
                    if v >= 1 << 63:
                        v -= 1 << 64
                    vals.append(v)
            return "int64", vals
    return "bytes", []


def decode_example(buf):
    """Serialized Example → ``{name: (kind, values)}``."""
    out = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        if tag >> 3 != 1 or tag & 7 != 2:
            raise ValueError("not an Example proto")
        length, pos = _read_varint(buf, pos)
        features_buf = buf[pos : pos + length]
        pos += length
        fpos = 0
        while fpos < len(features_buf):
            ftag, fpos = _read_varint(features_buf, fpos)
            assert ftag >> 3 == 1 and ftag & 7 == 2, "bad Features map entry"
            flen, fpos = _read_varint(features_buf, fpos)
            entry = features_buf[fpos : fpos + flen]
            fpos += flen
            epos = 0
            name, feature = None, ("bytes", [])
            while epos < len(entry):
                etag, epos = _read_varint(entry, epos)
                elen, epos = _read_varint(entry, epos)
                payload = entry[epos : epos + elen]
                epos += elen
                if etag >> 3 == 1:
                    name = payload.decode("utf-8")
                elif etag >> 3 == 2:
                    feature = _decode_feature(payload)
            if name is not None:
                out[name] = feature
    return out


# -- directory-level helpers ---------------------------------------------------


def write_shard(path, examples):
    """Write a list of feature-dicts as one TFRecord shard file."""
    parent = path.rsplit("/", 1)[0] if is_uri(path) else os.path.dirname(path)
    makedirs(parent)
    count = 0
    with TFRecordWriter(path) as w:
        for features in examples:
            w.write(encode_example(features))
            count += 1
    return count


def _is_shard_name(name):
    return name.startswith(("part-", "shard-")) and not name.endswith((".crc", ".tmp"))


def list_shards(directory):
    """TFRecord shard files under a directory (reference part-r-* layout);
    accepts local paths and fsspec URIs."""
    if is_uri(directory):
        fs, p = _fs(directory)
        out = []
        for entry in sorted(fs.ls(p, detail=False)):
            if _is_shard_name(entry.rsplit("/", 1)[-1]):
                out.append(fs.unstrip_protocol(entry))
        return out
    out = []
    for name in sorted(os.listdir(directory)):
        if _is_shard_name(name):
            out.append(os.path.join(directory, name))
    return out


def read_examples(path):
    for rec in read_records(path):
        yield decode_example(rec)
