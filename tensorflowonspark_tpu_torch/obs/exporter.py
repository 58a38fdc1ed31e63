"""Exporters: Prometheus text format + JSON, over a stdlib HTTP endpoint.

No ``prometheus_client`` dependency — the text exposition format (version
0.0.4) is small enough to render directly, and the repo's no-new-deps
constraint is hard. The renderer takes SNAPSHOTS (the aggregation plane's
wire format), not live registries, so one endpoint can serve a merged cluster
view (``TFCluster.metrics()``) as easily as a single process's registry.

Endpoints (:class:`MetricsHTTPServer`):

* ``GET /metrics``         → Prometheus text format, ``text/plain; version=0.0.4``
* ``GET /metrics.json``    → the raw snapshot dict as JSON (tests, bench.py)
* ``GET /trace``           → this process's flight-recorder shard as JSON
  (``{"records": [...], "torn": N, "shard": path}``) — the raw span/event
  stream :mod:`~tensorflowonspark_tpu_torch.obs.tracemerge` stitches cluster-wide,
  reachable per process while the run is still alive
* ``GET /histograms.json`` → per-histogram quantile summaries
  (``{name: {p50, p99, count, sum}}``) — the step-phase duration
  distributions (``step_fetch_seconds`` … ``step_compute_seconds``) the
  profiler records, without pulling full bucket arrays
* anything else            → 404

Prometheus rendering notes:

* histogram buckets are rendered CUMULATIVE with a final ``+Inf`` bucket equal
  to ``_count`` (the snapshot stores non-cumulative buckets — see
  ``registry.Histogram``);
* metric names are sanitized to ``[a-zA-Z_:][a-zA-Z0-9_:]*``;
* trace events are not rendered (Prometheus has no event type); they remain
  visible through the JSON endpoint.
"""

import json
import logging
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

logger = logging.getLogger(__name__)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _sanitize(name):
    if _NAME_OK.match(name):
        return name
    name = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not re.match(r"[a-zA-Z_:]", name[:1] or "_"):
        name = "_" + name
    return name


def _fmt(value):
    """Prometheus float formatting: integers render bare, +Inf as ``+Inf``."""
    if value == float("inf"):
        return "+Inf"
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


def render_prometheus(snap):
    """Render one snapshot (single-process or merged) as exposition text."""
    lines = []

    def _header(name, help_text, kind):
        if help_text:
            lines.append("# HELP {} {}".format(
                name, help_text.replace("\\", "\\\\").replace("\n", "\\n")
            ))
        lines.append("# TYPE {} {}".format(name, kind))

    for name, c in sorted((snap.get("counters") or {}).items()):
        name = _sanitize(name)
        _header(name, c.get("help", ""), "counter")
        lines.append("{} {}".format(name, _fmt(c.get("value", 0))))
    for name, g in sorted((snap.get("gauges") or {}).items()):
        name = _sanitize(name)
        _header(name, g.get("help", ""), "gauge")
        lines.append("{} {}".format(name, _fmt(g.get("value", 0))))
    for name, h in sorted((snap.get("histograms") or {}).items()):
        name = _sanitize(name)
        _header(name, h.get("help", ""), "histogram")
        cumulative = 0
        for le, n in h.get("buckets") or []:
            cumulative += n
            lines.append('{}_bucket{{le="{}"}} {}'.format(name, _fmt(le), _fmt(cumulative)))
        count = h.get("count", 0)
        lines.append('{}_bucket{{le="+Inf"}} {}'.format(name, _fmt(count)))
        lines.append("{}_sum {}".format(name, _fmt(h.get("sum", 0.0))))
        lines.append("{}_count {}".format(name, _fmt(count)))
    return "\n".join(lines) + "\n"


def render_json(snap):
    return json.dumps(snap, sort_keys=True)


def histogram_quantile(hist_snap, q):
    """Estimate quantile ``q`` from one histogram snapshot by linear
    interpolation inside the containing bucket (the textbook
    ``histogram_quantile`` estimator; observations above the last finite
    bound clamp to that bound)."""
    count = hist_snap.get("count", 0)
    if count <= 0:
        return None
    rank = q * count
    cumulative = 0
    lower = 0.0
    buckets = hist_snap.get("buckets") or []
    for le, n in buckets:
        if cumulative + n >= rank and n > 0:
            frac = (rank - cumulative) / n
            return lower + (le - lower) * min(1.0, max(0.0, frac))
        cumulative += n
        lower = le
    return buckets[-1][0] if buckets else None


def render_quantiles(snap, quantiles=(0.5, 0.99)):
    """Per-histogram quantile summary of a snapshot: the compact view of the
    step-phase duration distributions the profiler records."""
    out = {}
    for name, h in sorted((snap.get("histograms") or {}).items()):
        row = {"count": h.get("count", 0), "sum": h.get("sum", 0.0)}
        for q in quantiles:
            row["p{:g}".format(q * 100).replace(".", "_")] = histogram_quantile(h, q)
        out[name] = row
    return out


def local_trace():
    """This process's flight shard as a JSON-able dict (the /trace body).

    Reads the shard back from disk (not memory) so the endpoint shows
    exactly what a post-mortem merge would see; empty when the tracing
    plane is inert."""
    from tensorflowonspark_tpu_torch.obs import flight

    rec = flight.current(create=False)
    if rec is None:
        return {"records": [], "torn": 0, "shard": None}
    records, torn = flight.read_shard(rec.shard_dir)
    return {"records": records, "torn": torn, "shard": rec.shard_dir}


class MetricsHTTPServer:
    """Tiny threaded HTTP server exposing a snapshot function.

    ``snapshot_fn`` is called per request — pass ``registry.snapshot`` for a
    live process view or ``cluster.metrics`` for the merged driver view::

        srv = MetricsHTTPServer(obs.snapshot, port=9100).start()
        ...
        srv.stop()
    """

    def __init__(self, snapshot_fn, host="", port=0):
        self._snapshot_fn = snapshot_fn
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                try:
                    snap = outer._snapshot_fn()
                    if self.path in ("/metrics", "/"):
                        body = render_prometheus(snap).encode("utf-8")
                        ctype = CONTENT_TYPE
                    elif self.path == "/metrics.json":
                        body = render_json(snap).encode("utf-8")
                        ctype = "application/json"
                    elif self.path == "/histograms.json":
                        body = json.dumps(render_quantiles(snap), sort_keys=True).encode("utf-8")
                        ctype = "application/json"
                    elif self.path == "/trace":
                        body = json.dumps(local_trace(), sort_keys=True).encode("utf-8")
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception as e:  # a broken snapshot must not kill the server
                    self.send_error(500, str(e))
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # route to logging, not stderr
                logger.debug("metrics http: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.address = self._httpd.server_address
        self._thread = None

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="tos-metrics-http", daemon=True
        )
        self._thread.start()
        logger.info("metrics endpoint at http://%s:%s/metrics", *self.address)
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
