"""Shared helpers of the port's image-plane tests: shards written with the
JAX package's encoders (PIL) from a numpy seed, a range-capable HTTP server
over a directory (loopback only), and a pipeline's batches as bytes."""

import contextlib
import functools
import http.server
import os
import threading

import numpy as np

from tensorflowonspark_tpu import tfrecord
from tensorflowonspark_tpu.data import cifar, imagenet


def write_imagenet_shards(root, n=40, shards=2, seed=0, name="imagenet", sizes=((40, 52), (57, 45), (48, 48))):
    """``n`` JPEG Examples (labels = global index) in ``shards`` shards,
    image sizes cycling through ``sizes`` (h, w): uint8 pixels from
    ``seed``, encoded by the JAX package's ``imagenet.encode_example``."""
    rng = np.random.default_rng(seed)
    d = os.path.join(str(root), name)
    os.makedirs(d, exist_ok=True)
    per = -(-n // shards)
    paths = []
    for s in range(shards):
        path = os.path.join(d, "part-{:05d}".format(s))
        with tfrecord.TFRecordWriter(path) as w:
            for i in range(s * per, min(n, (s + 1) * per)):
                h, wd = sizes[i % len(sizes)]
                w.write(imagenet.encode_example(rng.integers(0, 256, (h, wd, 3), dtype=np.uint8), i))
        paths.append(path)
    return paths


def write_cifar_shards(root, n=40, shards=2, seed=0, name="cifar"):
    """``n`` raw-pixel CIFAR Examples (label = index % 10) in ``shards``
    shards, written by the JAX package's ``cifar.encode_example``."""
    rng = np.random.default_rng(seed)
    d = os.path.join(str(root), name)
    os.makedirs(d, exist_ok=True)
    per = -(-n // shards)
    paths = []
    for s in range(shards):
        path = os.path.join(d, "part-{:05d}".format(s))
        with tfrecord.TFRecordWriter(path) as w:
            for i in range(s * per, min(n, (s + 1) * per)):
                w.write(cifar.encode_example(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8), i % 10))
        paths.append(path)
    return paths


def stream(pipe, n_batches=None):
    """A pipeline's batches as ``(image dtype, image shape, image bytes,
    label bytes)`` tuples: equal lists mean byte-identical streams."""
    out = []
    for batch in pipe:
        image, label = np.asarray(batch["image"]), np.asarray(batch["label"])
        out.append((image.dtype.str, image.shape, image.tobytes(), label.tobytes()))
        if n_batches and len(out) == n_batches:
            break
    return out


class RangeHandler(http.server.SimpleHTTPRequestHandler):
    """Directory server that honors single byte ranges with 206, the
    object-store access pattern the stock handler ignores."""

    def log_message(self, *args):
        pass

    def do_GET(self):
        path = self.translate_path(self.path)
        if os.path.isdir(path):
            return super().do_GET()  # directory-index listing
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            self.send_error(404)
            return
        rng = self.headers.get("Range", "")
        if rng.startswith("bytes="):
            start_s, _, end_s = rng[len("bytes="):].partition("-")
            start = int(start_s)
            if start >= len(data):
                self.send_response(416)
                self.send_header("Content-Range", "bytes */{}".format(len(data)))
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            end = min(int(end_s) if end_s else len(data) - 1, len(data) - 1)
            body = data[start : end + 1]
            self.send_response(206)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Content-Range", "bytes {}-{}/{}".format(start, end, len(data)))
            self.end_headers()
            self.wfile.write(body)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@contextlib.contextmanager
def serve_dir(directory):
    """``http://127.0.0.1:<port>`` serving ``directory`` for the block."""
    srv = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(RangeHandler, directory=str(directory)))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield "http://127.0.0.1:{}".format(srv.server_address[1])
    finally:
        srv.shutdown()
        srv.server_close()
