"""ctypes binding for the port's native TFRecord reader/writer and JPEG
decoder (``csrc/tfrecord_io.cc``, a copy of the JAX package's
``native/tfrecord_io.cc``).

The bulk-ingest hot path: one FFI call loads and CRC-verifies a whole shard,
and records are sliced out of a single contiguous buffer — no per-record
Python framing work. The JPEG half decodes a record and lands its
Pillow-exact crop/resize/flip straight in a batch slot.

The library is built from the port's source at first use, with ``g++``,
into ``build/native/libtfrecord_io_<backend>_<hash>.so`` in the checkout
(the hash covers the source and the flags, so a stale build is never
loaded; the JAX package's prebuilt ``native/libtfrecord_io.so`` never is).
The JPEG backend follows the JAX package's Makefile probe: the system
libjpeg where ``jpeglib.h`` compiles and links, else the in-tree scalar
decoder, which replicates libjpeg's integer pipeline bit for bit
(``build(jpeg="scalar")`` builds it on a host that has libjpeg too).
Without a compiler every caller falls back to the Python codec and PIL.
"""

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading

from tensorflowonspark_tpu_torch import chaos, durable, resilience
from tensorflowonspark_tpu_torch.ops import cuda_build
from tensorflowonspark_tpu_torch.store import framing

logger = logging.getLogger(__name__)

#: retry policy for shard reads: network filesystems (gcsfuse, NFS) fail
#: transiently under pressure, and a re-read is cheap next to losing the
#: whole ingest wave. Genuine corruption still surfaces after the budget.
READ_RETRY = resilience.RetryPolicy(
    max_attempts=3,
    backoff=resilience.Backoff(base=0.1, factor=2.0, max_delay=1.0, jitter=0.5),
    retry_on=(IOError,),
    name="native-io-read",
)

SOURCE = os.path.join(cuda_build.CSRC, "tfrecord_io.cc")
BUILD_DIR = os.path.join(cuda_build.ROOT, "build", "native")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_lib = None
_lib_lock = threading.Lock()
_load_attempted = False


def _cxx():
    return os.environ.get("CXX") or shutil.which("g++")


def _have_libjpeg(cxx):
    """The Makefile's probe: does a program including ``jpeglib.h`` compile
    and link against ``-ljpeg`` here?"""
    probe = "#include <stdio.h>\n#include <jpeglib.h>\nint main(){return 0;}\n"
    try:
        out = subprocess.run([cxx, "-x", "c++", "-", "-o", os.devnull, "-ljpeg"],
                             input=probe, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return False
    return out.returncode == 0


def build(jpeg=None, build_dir=BUILD_DIR):
    """Compile ``csrc/tfrecord_io.cc`` unless a build of these bytes and
    flags exists; returns the library's path. ``jpeg`` is ``"libjpeg"`` or
    ``"scalar"`` (default: libjpeg where the probe passes). ``g++`` writes
    to a private name, fsynced and renamed into place (the directory
    fsynced after), so concurrent builders never load a half-written
    library."""
    cxx = _cxx()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) to build {}".format(SOURCE))
    if jpeg is None:
        jpeg = "libjpeg" if _have_libjpeg(cxx) else "scalar"
    flags = CXX_FLAGS + (["-DTFR_USE_LIBJPEG"] if jpeg == "libjpeg" else [])
    libs = ["-ljpeg"] if jpeg == "libjpeg" else []
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags + libs).encode()).hexdigest()[:16]
    path = os.path.join(build_dir, "libtfrecord_io_{}_{}.so".format(jpeg, digest))
    if os.path.isfile(path):
        return path
    os.makedirs(build_dir, exist_ok=True)
    tmp = "{}.{}.tmp".format(path, os.getpid())
    out = subprocess.run([cxx] + flags + ["-o", tmp, SOURCE] + libs,
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError("g++ failed to build {}:\n{}".format(SOURCE, out.stderr[-4000:]))
    durable.fsync_file(tmp)
    os.replace(tmp, path)
    durable.fsync_dir(build_dir)
    return path


def _bind(lib):
    lib.tfr_load.restype = ctypes.c_void_p
    lib.tfr_load.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.tfr_free.restype = None
    lib.tfr_free.argtypes = [ctypes.c_void_p]
    lib.tfr_count.restype = ctypes.c_uint64
    lib.tfr_count.argtypes = [ctypes.c_void_p]
    lib.tfr_buffer.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.tfr_buffer.argtypes = [ctypes.c_void_p]
    lib.tfr_buffer_len.restype = ctypes.c_uint64
    lib.tfr_buffer_len.argtypes = [ctypes.c_void_p]
    lib.tfr_offsets.restype = ctypes.POINTER(ctypes.c_uint64)
    lib.tfr_offsets.argtypes = [ctypes.c_void_p]
    lib.tfr_lengths.restype = ctypes.POINTER(ctypes.c_uint64)
    lib.tfr_lengths.argtypes = [ctypes.c_void_p]
    lib.tfr_last_error.restype = ctypes.c_char_p
    lib.tfr_last_error.argtypes = []
    lib.tfr_write.restype = ctypes.c_int
    lib.tfr_write.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64,
    ]
    lib.tfr_masked_crc32c.restype = ctypes.c_uint32
    lib.tfr_masked_crc32c.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64]
    lib.tfr_stream_open.restype = ctypes.c_void_p
    lib.tfr_stream_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.tfr_stream_close.restype = None
    lib.tfr_stream_close.argtypes = [ctypes.c_void_p]
    lib.tfr_stream_next.restype = ctypes.c_void_p
    lib.tfr_stream_next.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.tfr_build_info.restype = ctypes.c_char_p
    lib.tfr_build_info.argtypes = []
    lib.jpg_info.restype = ctypes.c_int32
    lib.jpg_info.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.jpg_decode_window.restype = ctypes.c_int32
    lib.jpg_decode_window.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_void_p,
        ctypes.c_int64,
    ]
    return lib


def load(path):
    """The library at ``path``, bound (``.path`` names it)."""
    lib = _bind(ctypes.CDLL(path))
    lib.path = path
    return lib


def load_library():
    """The bound ctypes library (built on first call), or None when it
    cannot be built or loaded here."""
    global _lib, _load_attempted
    with _lib_lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        try:
            _lib = load(build())
            logger.info("native tfrecord_io loaded from %s", _lib.path)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            logger.warning("native tfrecord_io unavailable (%s); using the Python codec and PIL", e)
            _lib = None
        return _lib


def available():
    return load_library() is not None


def read_records(path, verify_crc=True):
    """All record payloads of one shard as a list of ``bytes``.

    Raises IOError on corruption/truncation (message carried up from C),
    after ``READ_RETRY`` exhausts its budget (transient filesystem errors
    heal on a re-read; corrupt bytes don't).
    """
    return READ_RETRY.call(_read_records_once, path, verify_crc)


def _slice_records(lib, handle):
    """Record payloads out of one loaded handle (bulk file or stream chunk):
    one copy per record straight out of the C buffer (a whole-buffer bytes
    intermediate would double peak memory on the ingest path)."""
    count = lib.tfr_count(handle)
    base = ctypes.cast(lib.tfr_buffer(handle), ctypes.c_void_p).value
    offsets = lib.tfr_offsets(handle)
    lengths = lib.tfr_lengths(handle)
    return [ctypes.string_at(base + offsets[i], lengths[i]) for i in range(count)]


def _read_records_once(path, verify_crc=True):
    lib = load_library()
    if lib is None:
        raise RuntimeError("native tfrecord_io not available")
    if chaos.active and chaos.fire("native_io.read_fail"):
        raise IOError("chaos: injected transient read failure for {}".format(path))
    handle = lib.tfr_load(path.encode(), 1 if verify_crc else 0)
    if not handle:
        raise IOError(lib.tfr_last_error().decode() or "tfr_load failed on {}".format(path))
    try:
        return _slice_records(lib, handle)
    finally:
        lib.tfr_free(handle)


def stream_available():
    """True when the chunked streaming API can be used (the library built)."""
    return available()


def _stream_open(lib, path, verify_crc):
    if chaos.active and chaos.fire("native_io.read_fail"):
        raise IOError("chaos: injected transient read failure for {}".format(path))
    handle = lib.tfr_stream_open(path.encode(), 1 if verify_crc else 0)
    if not handle:
        raise IOError(
            lib.tfr_last_error().decode() or "tfr_stream_open failed on {}".format(path)
        )
    return handle


class _StreamChunkReader(framing.ChunkReader):
    """The native stream behind the shared ``open → read_chunk → close``
    chunk contract (:mod:`tensorflowonspark_tpu_torch.store.framing`): opening
    fires the ``native_io.read_fail`` chaos seam, and ``read_chunk`` slices
    one ``tfr_stream_next`` buffer per call."""

    def __init__(self, lib, path, verify_crc):
        self._lib = lib
        self._handle = _stream_open(lib, path, verify_crc)

    def read_chunk(self, max_records):
        chunk = self._lib.tfr_stream_next(self._handle, int(max_records))
        if not chunk:
            err = self._lib.tfr_last_error().decode()
            if err:
                raise IOError(err)
            return []  # clean EOF
        try:
            return _slice_records(self._lib, chunk)
        finally:
            self._lib.tfr_free(chunk)

    def close(self):
        handle, self._handle = self._handle, None
        if handle:
            self._lib.tfr_stream_close(handle)


def open_chunk_reader(path, verify_crc=True):
    """A :class:`_StreamChunkReader` over one shard (the native fast path
    ``store.LocalStore.open`` hands to the loader). Raises ``RuntimeError``
    when the library is unavailable — check :func:`stream_available`
    first."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native tfrecord_io streaming not available")
    return _StreamChunkReader(lib, path, verify_crc)


def read_records_chunked(path, chunk_records=1024, verify_crc=True):
    """Yield lists of up to ``chunk_records`` record payloads, reading the
    shard incrementally (``tfr_stream_next``) instead of materializing it.

    Peak memory is one chunk (plus the OS page cache), and the first record
    flows after one chunk's worth of IO instead of a whole shard's. The open
    is retried under ``READ_RETRY`` (transient filesystem errors);
    mid-stream corruption is NOT retried — the stream position is gone, and
    corrupt bytes don't heal. Both behaviors come from the shared chunk loop
    (:func:`tensorflowonspark_tpu_torch.store.framing.iter_chunks`).
    """
    lib = load_library()
    if lib is None:
        raise RuntimeError("native tfrecord_io streaming not available")
    return framing.iter_chunks(
        lambda: _StreamChunkReader(lib, path, verify_crc),
        chunk_records,
        retry=READ_RETRY,
    )


def write_records(path, records):
    """Write an iterable of payload ``bytes`` as one TFRecord shard."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native tfrecord_io not available")
    records = list(records)
    payloads = b"".join(records)
    n = len(records)
    offsets = (ctypes.c_uint64 * n)()
    lengths = (ctypes.c_uint64 * n)()
    pos = 0
    for i, rec in enumerate(records):
        offsets[i] = pos
        lengths[i] = len(rec)
        pos += len(rec)
    buf = (ctypes.c_uint8 * len(payloads)).from_buffer_copy(payloads) if payloads else (ctypes.c_uint8 * 1)()
    rc = lib.tfr_write(path.encode(), buf, offsets, lengths, n)
    if rc != 0:
        raise IOError(lib.tfr_last_error().decode() or "tfr_write failed on {}".format(path))
    return n


def masked_crc32c(data):
    """Masked crc32c via the native library (the framing's fallback where
    ``google_crc32c`` is missing, and the tests' cross-check)."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native tfrecord_io not available")
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data) if data else (ctypes.c_uint8 * 1)()
    return lib.tfr_masked_crc32c(buf, len(data))


#: env kill-switch: TOS_NATIVE_DECODE=0 forces the PIL decode path
#: (bit-exactness A/B runs, and an escape hatch if a platform's decode ever
#: diverges)
DECODE_ENV_VAR = "TOS_NATIVE_DECODE"


def jpg_available():
    """True when native JPEG decode can be used: the library built and
    :data:`DECODE_ENV_VAR` doesn't veto it."""
    if os.environ.get(DECODE_ENV_VAR, "1") == "0":
        return False
    return available()


def build_info():
    """The native build fingerprint string (``tfr_build_info()``):
    ``"tfrecord_io jpeg=libjpeg-turbo api=62"`` or ``"tfrecord_io
    jpeg=scalar"``; None when no library could be built."""
    lib = load_library()
    if lib is None:
        return None
    return lib.tfr_build_info().decode()


class JpegError(ValueError):
    """Native JPEG decode failed: corrupt/truncated stream or a coding the
    backend doesn't support. A ``ValueError`` so the loader's bad-record
    accounting treats it exactly like a PIL decode failure."""


def jpg_info(data):
    """``(width, height)`` from the JPEG header, without a full decode."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native JPEG decode not available")
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    if lib.jpg_info(data, len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise JpegError(lib.tfr_last_error().decode() or "jpg_info failed")
    return w.value, h.value


def jpg_decode_window(data, out, box, resize, window_origin=(0, 0), flip=False):
    """Decode ``data`` and write a resized window straight into ``out``.

    The single-call native hot path: decode, Pillow-exact bilinear resize of
    the source rect ``box`` (``(x0, y0, x1, y1)`` floats, PIL ``box=``
    semantics) to ``resize`` (``(width, height)``), then the window of that
    resize starting at ``window_origin`` with ``out``'s shape — horizontally
    mirrored when ``flip`` — lands in ``out``: a C-contiguous-rows uint8
    ``(H, W, 3)`` numpy view, typically a shared-memory slab slot. No PIL,
    no intermediate copy; the GIL is released for the call (ctypes).
    Raises :class:`JpegError` on corrupt input or an unsupported coding
    (the caller falls back to PIL).
    """
    lib = load_library()
    if lib is None:
        raise RuntimeError("native JPEG decode not available")
    if out.dtype.str != "|u1" or out.ndim != 3 or out.shape[2] != 3:
        raise ValueError("out must be a uint8 (H, W, 3) array, got {} {}".format(
            out.dtype, out.shape))
    if out.strides[1] != 3 or out.strides[2] != 1:
        raise ValueError("out rows must be C-contiguous")
    oh, ow = out.shape[0], out.shape[1]
    ox, oy = window_origin
    rc = lib.jpg_decode_window(
        data, len(data),
        float(box[0]), float(box[1]), float(box[2]), float(box[3]),
        int(resize[0]), int(resize[1]),
        int(ox), int(oy), int(ow), int(oh),
        1 if flip else 0,
        out.ctypes.data_as(ctypes.c_void_p), out.strides[0],
    )
    if rc != 0:
        raise JpegError(lib.tfr_last_error().decode() or "jpg_decode_window failed")
