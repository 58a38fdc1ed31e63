"""The port's native library (``csrc/tfrecord_io.cc``, built by
``native_io`` at first use) against the Python codec, PIL and the JAX
package: record framing byte for byte, and the JPEG decoder's pixels
exactly PIL's across the decode matrix of the JAX package's
``test_native_io.py`` — for both backends the build can choose (libjpeg
where the host has it, and the in-tree scalar decoder, which the GPU host
runs, built here with ``build(jpeg="scalar")``)."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from tensorflowonspark_tpu import tfrecord as jax_tfrecord
from tensorflowonspark_tpu.data import imagenet as jax_imagenet
from tensorflowonspark_tpu_torch import native_io, tfrecord
from tensorflowonspark_tpu_torch.data import imagenet
from tensorflowonspark_tpu_torch.store import framing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(params=["auto", "scalar"])
def backend(request, monkeypatch):
    """The library of one JPEG backend in place of the loaded one for the
    test: the probe's choice, or the scalar decoder."""
    monkeypatch.delenv(native_io.DECODE_ENV_VAR, raising=False)
    jpeg = None if request.param == "auto" else request.param
    monkeypatch.setattr(native_io, "_lib", native_io.load(native_io.build(jpeg)))
    monkeypatch.setattr(native_io, "_load_attempted", True)
    return request.param


def _checker(w, h, mode="RGB", seed=0):
    """A deterministic test image with gradients and hard edges (catches
    upsampling and resampling off-by-ones)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    r = (xx * 255 // max(w - 1, 1)).astype(np.uint8)
    g = (yy * 255 // max(h - 1, 1)).astype(np.uint8)
    b = ((xx // 4 + yy // 4) % 2 * 255).astype(np.uint8)
    arr = np.stack([r, g, b], axis=-1)
    arr ^= rng.integers(0, 32, arr.shape, dtype=np.uint8)
    return arr[..., 0] if mode == "L" else arr


def _encode_jpg(arr, quality=90, subsampling=-1):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=quality, subsampling=subsampling)
    return buf.getvalue()


def _pil_window(data, box, resize, origin=(0, 0), size=None, flip=False):
    """The PIL oracle of decode → resize → window → flip."""
    img = Image.open(io.BytesIO(data))
    if img.mode != "RGB":
        img = img.convert("RGB")
    r = img.resize(resize, Image.BILINEAR, box=box)
    if size is None:
        size = (resize[1], resize[0])
    ox, oy = origin
    arr = np.asarray(r.crop((ox, oy, ox + size[1], oy + size[0])))
    return arr[:, ::-1] if flip else arr


def test_library_builds_from_the_port_source_never_the_jax_prebuilt():
    """A fresh process maps the build of ``csrc/tfrecord_io.cc`` from the
    git-ignored ``build/native/`` and never ``native/libtfrecord_io.so``."""
    code = (
        "from tensorflowonspark_tpu_torch import native_io\n"
        "lib = native_io.load_library()\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(lib.path)\n"
        "print('jax-prebuilt-mapped' if 'native/libtfrecord_io.so' in maps else 'clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    path, mapped = out.stdout.split()
    assert os.path.dirname(path) == os.path.join(REPO, "build", "native")
    assert os.path.basename(path).startswith("libtfrecord_io_") and mapped == "clean"
    assert native_io.SOURCE == os.path.join(REPO, "tensorflowonspark_tpu_torch", "csrc", "tfrecord_io.cc")
    # a copy of the JAX package's source: only the comment naming where the
    # reference's jar lived is reworded
    with open(native_io.SOURCE) as port, open(os.path.join(REPO, "native", "tfrecord_io.cc")) as jax:
        port_lines, jax_lines = port.read().splitlines(), jax.read().splitlines()
    assert len(port_lines) == len(jax_lines)
    assert [i for i, (a, b) in enumerate(zip(port_lines, jax_lines)) if a != b] == [3]
    assert port_lines[3].startswith("// ") and jax_lines[3].startswith("// ")


def test_build_info_reports_the_backend(backend):
    want = "scalar" if backend == "scalar" or not native_io._have_libjpeg(native_io._cxx()) else "libjpeg"
    info = native_io.build_info()
    assert info == "tfrecord_io jpeg=scalar" if want == "scalar" else info.startswith(
        "tfrecord_io jpeg=libjpeg-turbo api=")
    assert "_{}_".format(want) in os.path.basename(native_io.load_library().path)


def test_records_interchange_with_the_python_codec_and_the_jax_reader(tmp_path):
    recs = [os.urandom(i * 13 + 1) for i in range(40)] + [b""]
    for data in recs[:8]:
        assert native_io.masked_crc32c(data) == framing.masked_crc(data) == jax_tfrecord._masked_crc(data)
    native_path = str(tmp_path / "native.tfrecord")
    assert native_io.write_records(native_path, recs) == len(recs)
    assert list(jax_tfrecord.read_records(native_path)) == recs
    py_path = str(tmp_path / "python.tfrecord")
    with tfrecord.TFRecordWriter(py_path) as w:
        for r in recs:
            w.write(r)
    assert native_io.read_records(py_path) == recs
    assert [r for chunk in native_io.read_records_chunked(py_path, chunk_records=7) for r in chunk] == recs
    with open(native_path, "rb") as a, open(py_path, "rb") as b:
        assert a.read() == b.read()


def test_corruption_detected(tmp_path):
    path = str(tmp_path / "good.tfrecord")
    native_io.write_records(path, [b"payload-one", b"payload-two"])
    blob = bytearray(open(path, "rb").read())
    blob[14] ^= 0xFF  # a payload byte of record 0
    bad = str(tmp_path / "bad.tfrecord")
    open(bad, "wb").write(bytes(blob))
    with pytest.raises(IOError):
        native_io.read_records(bad)
    assert len(native_io.read_records(bad, verify_crc=False)) == 2


def test_framing_uses_the_native_crc_without_google_crc32c(tmp_path, monkeypatch):
    """A host without ``google_crc32c`` (the GPU host) frames records with
    the native crc: the same bytes as the package's."""
    monkeypatch.setattr(framing, "google_crc32c", None)
    monkeypatch.setattr(framing, "_native_masked", [])
    data = os.urandom(5000)
    assert framing.masked_crc(data) == jax_tfrecord._masked_crc(data)
    assert framing._native_masked == [native_io.masked_crc32c]


def test_jpg_decode_matrix_matches_pil_exactly(backend):
    """Raster decode across the codings PIL emits: quality × subsampling ×
    geometry (odd sizes, tiny images where libjpeg replicates instead of
    fancy-upsampling, grayscale), identity resize."""
    cases = [(64, 48, "RGB"), (17, 11, "RGB"), (5, 3, "RGB"), (2, 2, "RGB"),
             (1, 1, "RGB"), (24, 24, "L"), (7, 16, "L")]
    for quality in (50, 90, 100):
        for subsampling in (0, 1, 2):
            for w, h, mode in cases:
                data = _encode_jpg(_checker(w, h, mode), quality, subsampling)
                assert native_io.jpg_info(data) == (w, h)
                out = np.empty((h, w, 3), np.uint8)
                native_io.jpg_decode_window(data, out, (0, 0, w, h), (w, h))
                assert np.array_equal(out, _pil_window(data, (0, 0, w, h), (w, h))), (
                    "decode mismatch at q={} ss={} {}x{} {} ({})".format(
                        quality, subsampling, w, h, mode, native_io.build_info()))


def test_jpg_decode_window_geometry_matches_pil(backend):
    """The pipeline's geometries: a fractional train crop-box + resize +
    flip, eval's full-frame resize + centred window, an off-origin window
    of an upscale."""
    data = _encode_jpg(_checker(61, 43))
    for box, resize, origin, size, flip in [
        ((3.25, 2.5, 50.75, 40.0), (32, 32), (0, 0), None, True),
        ((3.25, 2.5, 50.75, 40.0), (32, 32), (0, 0), None, False),
        ((0, 0, 61, 43), (91, 64), (33, 10), (48, 48), False),
        ((0, 0, 61, 43), (122, 86), (5, 7), (40, 60), True),
    ]:
        size = size or (resize[1], resize[0])
        out = np.empty(size + (3,), np.uint8)
        native_io.jpg_decode_window(data, out, box, resize, origin, flip)
        assert np.array_equal(out, _pil_window(data, box, resize, origin, size, flip))


def test_jpg_decode_into_strided_slab_rows(backend):
    """A slab slot with a padded row stride: the decoder writes through
    ``strides[0]`` and leaves the padding alone."""
    data = _encode_jpg(_checker(30, 20))
    backing = np.full((16, 16 * 3 + 13), 0xAB, np.uint8)
    out = backing[:, :16 * 3].reshape(16, 16, 3)[:12, :10]
    native_io.jpg_decode_window(data, out, (0, 0, 30, 20), (14, 16), (2, 3))
    assert np.array_equal(out, _pil_window(data, (0, 0, 30, 20), (14, 16), (2, 3), (12, 10)))
    assert (backing[:, 16 * 3:] == 0xAB).all()


def test_parse_into_matches_the_jax_parse(backend):
    """The port's native ``parse.into`` lands the JAX package's PIL parse's
    pixels, train (crop-box draws, then the flip draw) and eval."""
    for is_training in (True, False):
        parse = imagenet.make_parse_fn(is_training, image_size=32, seed=7, raw_uint8=True)
        jparse = jax_imagenet.make_parse_fn(is_training, image_size=32, seed=7, raw_uint8=True)
        assert parse.cache_key == jparse.cache_key
        for i in range(6):
            rec = jax_imagenet.encode_example(_checker(57 + 3 * i, 49 + 2 * i, seed=i), i)
            want, want_label = jparse(rec)
            out = np.empty((32, 32, 3), np.uint8)
            label, used_native = parse.into(rec, out)
            assert used_native and label == want_label
            assert np.array_equal(out, want)


def test_jpg_corrupt_and_truncated_raise_jpegerror(backend):
    data = _encode_jpg(_checker(32, 24))
    out = np.empty((24, 32, 3), np.uint8)
    for bad in [b"", b"\xff\xd8", data[: len(data) // 2], b"not a jpeg at all", data[:2] + b"\x00" * 64]:
        with pytest.raises(ValueError):  # JpegError is a ValueError
            native_io.jpg_info(bad)
        with pytest.raises(native_io.JpegError):
            native_io.jpg_decode_window(bad, out, (0, 0, 32, 24), (32, 24))


def test_decode_env_var_vetoes_the_native_path(monkeypatch):
    """``TOS_NATIVE_DECODE=0``: ``parse.into`` takes PIL, same pixels."""
    rec = jax_imagenet.encode_example(_checker(40, 36), 3)
    parse = imagenet.make_parse_fn(True, image_size=16, seed=1, raw_uint8=True)
    native_out = np.empty((16, 16, 3), np.uint8)
    assert parse.into(rec, native_out) == (3, True)
    monkeypatch.setenv(native_io.DECODE_ENV_VAR, "0")
    assert not native_io.jpg_available()
    pil_out = np.empty((16, 16, 3), np.uint8)
    assert parse.into(rec, pil_out) == (3, False)
    assert np.array_equal(native_out, pil_out)
