"""``HTTPStore`` — remote object-store shard source over HTTP range-GETs.

Shards are read in ``TOS_STORE_RANGE_BYTES``-sized ranged requests (the
object-store access pattern: no open handles, no server state), with the
shared Python framing (:mod:`~tensorflowonspark_tpu_torch.store.framing`) sliced
on top — so a remote shard streams through the loader chunk-for-chunk
identically to a local one. Every request runs under
:data:`STORE_READ_RETRY` (transient network errors heal on a re-request;
a mid-record CRC mismatch does not and is surfaced, exactly the local
contract).

GCS and S3 ride the same code path via **endpoint adapters**: an adapter
maps ``gs://bucket/key`` / ``s3://bucket/key`` names onto plain HTTP
object URLs against a configurable endpoint and knows that service's
listing API (GCS JSON API, S3 ListObjectsV2 XML). The default
:class:`IndexHtmlAdapter` speaks directory-index HTML (``http.server``,
nginx autoindex) — which is also what the in-process test fixture serves,
so the whole store is exercised without cloud credentials.

Chaos seams: ``store.read_error`` makes one request raise ``IOError``
(absorbed by the retry budget, visible in ``resilience_retries_total`` and
the per-site fault counter); ``store.remote_stall`` sleeps inside the
request — the latency lands in shard-read time, so ``classify_stalls``
calls the run io_bound and the prefetch autotuner must deepen.
"""

import html.parser
import json
import os
import threading
import urllib.error
import urllib.parse
import urllib.request

from tensorflowonspark_tpu_torch import chaos, obs, resilience
from tensorflowonspark_tpu_torch.store import base, framing

#: bytes per range-GET — large enough to amortize request latency, small
#: enough that a chunked read never buffers more than a few MiB per shard
DEFAULT_RANGE_BYTES = 4 * 1024 * 1024
RANGE_ENV = "TOS_STORE_RANGE_BYTES"

#: per-request timeout, seconds
_REQUEST_TIMEOUT = 30.0

#: retry policy for remote object reads: one budget for every HTTP request
#: the store issues (stat, list, ranged read) — object stores throw
#: transient 5xx/conn-reset under load and a re-request is cheap next to
#: losing the shard
STORE_READ_RETRY = resilience.RetryPolicy(
    max_attempts=4,
    backoff=resilience.Backoff(base=0.05, factor=2.0, max_delay=1.0, jitter=0.5),
    retry_on=(OSError,),
    name="store-read",
)


def resolve_range_bytes(range_bytes=None):
    if range_bytes is None:
        range_bytes = int(os.environ.get(RANGE_ENV, str(DEFAULT_RANGE_BYTES)))
    return max(1, int(range_bytes))


class _HrefParser(html.parser.HTMLParser):
    def __init__(self):
        super().__init__()
        self.hrefs = []

    def handle_starttag(self, tag, attrs):
        if tag == "a":
            for name, value in attrs:
                if name == "href" and value:
                    self.hrefs.append(value)


class IndexHtmlAdapter:
    """Plain-HTTP endpoint adapter: object names ARE URLs, and listings
    come from the server's directory-index page (``http.server``, nginx
    autoindex — and the in-process test fixture)."""

    def handles(self, path):
        return str(path).startswith(("http://", "https://"))

    def object_url(self, path):
        return str(path)

    def list_names(self, store, root):
        root = str(root).rstrip("/") + "/"
        body = store.request(root).decode("utf-8", "replace")
        parser = _HrefParser()
        parser.feed(body)
        names = []
        for href in parser.hrefs:
            name = urllib.parse.unquote(href.rstrip("/").rsplit("/", 1)[-1])
            if name and not href.endswith("/"):
                names.append(name)
        return root, names


class GCSAdapter:
    """``gs://bucket/key`` → the GCS XML/JSON endpoints (public or
    emulated; ``endpoint`` points tests at a local fixture). No auth —
    credentialed access belongs to a fronting proxy, not this reader."""

    scheme = "gs://"

    def __init__(self, endpoint="https://storage.googleapis.com"):
        self.endpoint = endpoint.rstrip("/")

    def handles(self, path):
        return str(path).startswith(self.scheme)

    def _split(self, path):
        bucket, _, key = str(path)[len(self.scheme):].partition("/")
        return bucket, key

    def object_url(self, path):
        bucket, key = self._split(path)
        return "{}/{}/{}".format(self.endpoint, bucket, urllib.parse.quote(key))

    def list_names(self, store, root):
        bucket, prefix = self._split(root)
        url = "{}/storage/v1/b/{}/o?prefix={}".format(
            self.endpoint, bucket, urllib.parse.quote(prefix)
        )
        items = json.loads(store.request(url).decode()).get("items", [])
        base_root = str(root).rstrip("/") + "/"
        names = []
        for item in items:
            key = item.get("name", "")
            tail = key[len(prefix):].lstrip("/")
            if tail and "/" not in tail:
                names.append(tail)
        return base_root, names


class S3Adapter:
    """``s3://bucket/key`` → path-style S3 endpoints via ListObjectsV2
    (public or emulated; ``endpoint`` points tests at a local fixture)."""

    scheme = "s3://"

    def __init__(self, endpoint="https://s3.amazonaws.com"):
        self.endpoint = endpoint.rstrip("/")

    def handles(self, path):
        return str(path).startswith(self.scheme)

    def _split(self, path):
        bucket, _, key = str(path)[len(self.scheme):].partition("/")
        return bucket, key

    def object_url(self, path):
        bucket, key = self._split(path)
        return "{}/{}/{}".format(self.endpoint, bucket, urllib.parse.quote(key))

    def list_names(self, store, root):
        import re

        bucket, prefix = self._split(root)
        url = "{}/{}?list-type=2&prefix={}".format(
            self.endpoint, bucket, urllib.parse.quote(prefix)
        )
        body = store.request(url).decode("utf-8", "replace")
        base_root = str(root).rstrip("/") + "/"
        names = []
        for key in re.findall(r"<Key>([^<]+)</Key>", body):
            tail = key[len(prefix):].lstrip("/")
            if tail and "/" not in tail:
                names.append(tail)
        return base_root, names


class _RangedFile:
    """Sequential file-like view of one remote object, reading ahead in
    ``range_bytes``-sized range-GETs so the per-record framing reads never
    hit the wire individually."""

    def __init__(self, store, url, size):
        self._store = store
        self._url = url
        self._size = int(size)
        self._pos = 0
        self._buf = b""
        self._buf_pos = 0

    def read(self, n):
        out = []
        need = int(n)
        while need > 0:
            avail = len(self._buf) - self._buf_pos
            if avail <= 0:
                if self._pos >= self._size:
                    break
                span = max(need, self._store.range_bytes)
                end = min(self._pos + span, self._size) - 1
                self._buf = self._store.read_range(self._url, self._pos, end)
                self._buf_pos = 0
                self._pos += len(self._buf)
                if not self._buf:
                    break
                continue
            take = min(avail, need)
            out.append(self._buf[self._buf_pos : self._buf_pos + take])
            self._buf_pos += take
            need -= take
        return b"".join(out)

    def close(self):
        self._buf = b""


class HTTPStore(base.ShardStore):
    """Remote shard source speaking HTTP range-GETs through an endpoint
    adapter (:class:`IndexHtmlAdapter` default; :class:`GCSAdapter` /
    :class:`S3Adapter` for ``gs://`` / ``s3://`` names)."""

    def __init__(self, adapter=None, range_bytes=None, retry=None):
        self.adapter = adapter or IndexHtmlAdapter()
        self.range_bytes = resolve_range_bytes(range_bytes)
        self.retry = retry or STORE_READ_RETRY
        self._lock = threading.Lock()
        self._sizes = {}  # object url -> size (stat cache for open())
        self._reads_c = obs.counter(
            "store_remote_reads_total",
            help="HTTP requests issued to remote shard stores",
        )
        self._bytes_c = obs.counter(
            "store_remote_bytes_total",
            help="bytes fetched from remote shard stores",
        )

    def handles(self, path):
        return self.adapter.handles(path)

    # -- HTTP primitives (every request funnels through here) ------------------

    def _request_once(self, url, headers=None, method="GET"):
        if chaos.active:
            if chaos.fire("store.read_error"):
                raise IOError("chaos: injected remote store read failure for {}".format(url))
            chaos.delay("store.remote_stall")
        req = urllib.request.Request(url, headers=headers or {}, method=method)
        try:
            with urllib.request.urlopen(req, timeout=_REQUEST_TIMEOUT) as resp:
                body = resp.read()
                self._reads_c.inc()
                self._bytes_c.inc(len(body))
                return resp.status, dict(resp.headers), body
        except urllib.error.HTTPError as e:
            if e.code == 416:  # past EOF: an empty range, not a failure
                return 416, dict(e.headers or {}), b""
            raise IOError("HTTP {} for {}".format(e.code, url))

    def request(self, url, headers=None, method="GET"):
        """One retried request; returns the body bytes."""
        status, _headers, body = self.retry.call(
            self._request_once, url, headers, method
        )
        return body

    def read_range(self, url, start, end):
        """Bytes ``[start, end]`` of the object (inclusive range). Servers
        that ignore the Range header (plain ``http.server``) answer 200
        with the whole body — sliced here so the framing above never
        notices the difference."""
        status, _headers, body = self.retry.call(
            self._request_once, url, {"Range": "bytes={}-{}".format(start, end)}
        )
        if status == 206:
            return body
        if status == 416:
            return b""
        return body[start : end + 1]

    # -- ShardStore ABI ---------------------------------------------------------

    def stat(self, path):
        url = self.adapter.object_url(path)
        status, headers, body = self.retry.call(self._request_once, url, None, "HEAD")
        length = headers.get("Content-Length")
        if length is None:
            # HEAD-less servers: fall back to a full GET for the size
            status, headers, body = self.retry.call(self._request_once, url)
            length = headers.get("Content-Length", len(body))
        size = int(length)
        with self._lock:
            self._sizes[url] = size
        return {"size": size}

    def open(self, path, verify_crc=True):
        url = self.adapter.object_url(path)
        with self._lock:
            size = self._sizes.get(url)
        if size is None:
            size = self.stat(path)["size"]
        return framing.FramedChunkReader(
            _RangedFile(self, url, size), url, verify_crc=verify_crc
        )

    def list_shards(self, root):
        from tensorflowonspark_tpu_torch import tfrecord

        base_root, names = self.adapter.list_names(self, root)
        shards = [base_root + n for n in names if tfrecord._is_shard_name(n)]
        return sorted(shards, key=base.shard_sort_key)

    def fetch(self, path, out_f):
        url = self.adapter.object_url(path)
        size = self.stat(path)["size"]
        pos = 0
        while pos < size:
            end = min(pos + self.range_bytes, size) - 1
            block = self.read_range(url, pos, end)
            if not block:
                raise IOError("short remote object: {} ended at {}/{}".format(url, pos, size))
            out_f.write(block)
            pos += len(block)
        return pos

    def fingerprint(self):
        return "http adapter={} range_bytes={}".format(
            type(self.adapter).__name__, self.range_bytes
        )


def resolve_store(paths):
    """The store implied by a file list: ``http(s)://`` names get an
    :class:`HTTPStore`, ``gs://`` / ``s3://`` get one with the matching
    endpoint adapter, local paths get None (the loader's classic path).
    Mixed lists are rejected — one pipeline, one byte source."""
    schemes = set()
    for p in paths:
        p = str(p)
        if p.startswith(("http://", "https://")):
            schemes.add("http")
        elif p.startswith("gs://"):
            schemes.add("gs")
        elif p.startswith("s3://"):
            schemes.add("s3")
        else:
            schemes.add("local")
    if len(schemes) > 1:
        raise ValueError(
            "mixed shard sources {} — one pipeline reads one store".format(sorted(schemes))
        )
    scheme = schemes.pop() if schemes else "local"
    if scheme == "http":
        return HTTPStore()
    if scheme == "gs":
        return HTTPStore(adapter=GCSAdapter())
    if scheme == "s3":
        return HTTPStore(adapter=S3Adapter())
    return None
