"""The port's ``obs/exporter.py`` and ``obs/tracemerge.py`` on the CPU.

The cases of ``tests/test_obs_exporter.py`` and the tracemerge and exporter
cases of ``tests/test_tracing.py`` re-run against the port's copies, and
the two packages held against each other: the same registry snapshot
renders byte-identical Prometheus text, quantiles and JSON from both, and
the same flight shards merge into the same Chrome trace."""

import json
import os
import re
import urllib.error
import urllib.request

import pytest

from tensorflowonspark_tpu.obs import exporter as jexporter
from tensorflowonspark_tpu.obs import tracemerge as jtracemerge
from tensorflowonspark_tpu_torch import obs
from tensorflowonspark_tpu_torch.obs import exporter, flight, registry, tracemerge, tracing

SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r" (?P<value>[^ ]+)$"
)
HELP_RE = re.compile(r"^# HELP (?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*) (?P<text>.*)$")
TYPE_RE = re.compile(
    r"^# TYPE (?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*) (?P<kind>counter|gauge|histogram|summary|untyped)$"
)


def parse_exposition(text):
    """Exposition text → {family: {"type", "help", "samples"}}; raises on
    any line that is not text format 0.0.4 (the reference test's parser)."""
    assert text.endswith("\n"), "exposition text must end with a newline"
    families = {}
    current = None
    for line in text.splitlines():
        if not line.strip():
            continue
        m = HELP_RE.match(line)
        if m:
            families.setdefault(m.group("name"), {"samples": []})["help"] = m.group("text")
            continue
        m = TYPE_RE.match(line)
        if m:
            fam = families.setdefault(m.group("name"), {"samples": []})
            fam["type"] = m.group("kind")
            current = m.group("name")
            continue
        assert not line.startswith("#"), "unrecognized comment line: {!r}".format(line)
        m = SAMPLE_RE.match(line)
        assert m, "malformed sample line: {!r}".format(line)
        name, labels_raw, value = m.group("name", "labels", "value")
        labels = {}
        if labels_raw:
            for pair in labels_raw.split(","):
                lm = re.match(r'^([a-zA-Z_][a-zA-Z0-9_]*)="(.*)"$', pair)
                assert lm, "malformed label pair: {!r}".format(pair)
                labels[lm.group(1)] = lm.group(2)
        val = float("inf") if value == "+Inf" else float(value)
        fam_name = current if current and name.startswith(current) else name
        families.setdefault(fam_name, {"samples": []})["samples"].append((name, labels, val))
    return families


@pytest.fixture
def snap():
    reg = registry.Registry()
    reg.counter("requests_total", help="total requests").inc(3)
    reg.gauge("queue_depth", help="pending").set(2.5)
    h = reg.histogram("latency_seconds", help="latency", buckets=(0.1, 0.5, 1.0))
    for v in (0.05, 0.05, 0.3, 2.0):
        h.observe(v)
    return reg.snapshot()


# -- tests/test_obs_exporter.py on the port ------------------------------------


def test_counter_and_gauge_render(snap):
    fams = parse_exposition(exporter.render_prometheus(snap))
    assert fams["requests_total"]["type"] == "counter"
    assert fams["requests_total"]["help"] == "total requests"
    assert fams["requests_total"]["samples"] == [("requests_total", {}, 3.0)]
    assert fams["queue_depth"]["samples"] == [("queue_depth", {}, 2.5)]


def test_histogram_buckets_are_cumulative_and_inf_equals_count(snap):
    fam = parse_exposition(exporter.render_prometheus(snap))["latency_seconds"]
    assert fam["type"] == "histogram"
    buckets = {s[1]["le"]: s[2] for s in fam["samples"] if s[0] == "latency_seconds_bucket"}
    assert buckets == {"0.1": 2.0, "0.5": 3.0, "1": 3.0, "+Inf": 4.0}
    count = [s for s in fam["samples"] if s[0] == "latency_seconds_count"][0][2]
    assert buckets["+Inf"] == count == 4.0
    total = [s for s in fam["samples"] if s[0] == "latency_seconds_sum"][0][2]
    assert total == pytest.approx(2.4)


def test_names_sanitized_help_escaped_integers_bare():
    text = exporter.render_prometheus({"counters": {"bad-name.with spaces": {"value": 1, "help": ""}}})
    assert "bad_name_with_spaces" in parse_exposition(text)
    text = exporter.render_prometheus({"counters": {"c": {"value": 1, "help": "line1\nline2"}}})
    parse_exposition(text)
    assert "# HELP c line1\\nline2" in text
    assert "c 5\n" in exporter.render_prometheus({"counters": {"c": {"value": 5.0, "help": ""}}})


def test_render_json_round_trips(snap):
    assert json.loads(exporter.render_json(snap)) == json.loads(json.dumps(snap))


def test_http_server_serves_metrics_json_and_404():
    reg = registry.Registry()
    reg.counter("hits_total").inc(2)
    srv = exporter.MetricsHTTPServer(reg.snapshot, host="127.0.0.1", port=0).start()
    try:
        base = "http://127.0.0.1:{}".format(srv.address[1])
        resp = urllib.request.urlopen(base + "/metrics", timeout=10)
        assert resp.status == 200 and resp.headers["Content-Type"] == exporter.CONTENT_TYPE
        assert parse_exposition(resp.read().decode("utf-8"))["hits_total"]["samples"] == [
            ("hits_total", {}, 2.0)]
        resp = urllib.request.urlopen(base + "/metrics.json", timeout=10)
        assert json.loads(resp.read().decode("utf-8"))["counters"]["hits_total"]["value"] == 2
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(base + "/nope", timeout=10)
        assert exc_info.value.code == 404
    finally:
        srv.stop()


def test_http_server_survives_broken_snapshot_fn():
    def broken():
        raise RuntimeError("snapshot exploded")

    srv = exporter.MetricsHTTPServer(broken, host="127.0.0.1", port=0).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen("http://127.0.0.1:{}/metrics".format(srv.address[1]), timeout=10)
        assert exc_info.value.code == 500
    finally:
        srv.stop()


# -- the two packages on the same snapshot -------------------------------------


def _snapshots(snap):
    return [
        snap,
        {"counters": {"bad-name.with spaces": {"value": 1, "help": "a\nb"}}},
        {"counters": {"c": {"value": 5.0, "help": ""}}, "gauges": {"g": {"value": -0.125, "help": "x"}}},
        {"histograms": {"h": {"count": 10, "sum": 3.5, "help": "h", "buckets": [[1.0, 5], [2.0, 5]]}}},
    ]


@pytest.mark.parametrize("case", range(4))
def test_snapshot_renders_byte_identical_from_both_packages(snap, case):
    s = _snapshots(snap)[case]
    assert exporter.render_prometheus(s).encode() == jexporter.render_prometheus(s).encode()
    assert exporter.render_json(s) == jexporter.render_json(s)


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.75, 0.99, 1.0])
def test_histogram_quantile_equals_the_jax_packages(q):
    h = {"count": 10, "sum": 0.0, "buckets": [[1.0, 5], [2.0, 5]]}
    assert exporter.histogram_quantile(h, q) == jexporter.histogram_quantile(h, q)
    assert exporter.histogram_quantile({"count": 0, "buckets": []}, q) is None


def test_histogram_quantile_interpolates():
    h = {"count": 10, "sum": 0.0, "buckets": [[1.0, 5], [2.0, 5]]}
    assert exporter.histogram_quantile(h, 0.5) == pytest.approx(1.0)
    assert exporter.histogram_quantile(h, 0.75) == pytest.approx(1.5)


# -- tests/test_tracing.py: tracemerge and the exporter's endpoints -------------


@pytest.fixture
def trace_root(tmp_path, monkeypatch):
    root = str(tmp_path / "traces")
    tracing.reset()
    monkeypatch.setenv(flight.TRACE_DIR_ENV, root)
    yield root
    tracing.reset()


def _two_skewed_shards(root):
    """A driver shard and an executor shard whose clock runs 5 s behind;
    causal order driver a -> executor b -> driver c."""
    drv = flight.FlightRecorder(root, "driver", trace_id="t" * 32)
    drv.append({"kind": "span", "name": "reservation_roundtrip", "trace": "t" * 32, "span": "s1",
                "parent": None, "ts": 1000.0, "dur_s": 0.5, "ok": True, "tid": 1})
    drv.append({"kind": "event", "name": "lease_expired", "trace": "t" * 32, "span": "e1",
                "parent": "s1", "ts": 1002.0})
    drv.close()
    exe = flight.FlightRecorder(root, "executor0", trace_id="t" * 32)
    exe.set_clock_offset(5.0, rtt=0.01)
    exe.append({"kind": "span", "name": "node_launch", "trace": "t" * 32, "span": "s2", "parent": "s1",
                "ts": 996.0, "dur_s": 0.25, "ok": True, "tid": 2})
    exe.close()


def test_skewed_clocks_merge_into_ordered_timeline(tmp_path):
    root = str(tmp_path)
    _two_skewed_shards(root)
    trace, summary = tracemerge.merge_directory(root)
    assert tracemerge.validate_chrome_trace(trace) == []
    assert summary["trace_ids"] == ["t" * 32]
    offsets = {s["shard"].split("-")[-1]: s["clock_offset_s"] for s in summary["shards"]}
    assert offsets == {"driver": 0.0, "executor0": 5.0}
    begins = sorted((e["ts"], e["name"]) for e in trace["traceEvents"]
                    if e.get("ph") in ("B", "i") and e.get("cat") != "dump")
    assert [n for _, n in begins] == ["reservation_roundtrip", "node_launch", "lease_expired"]
    assert begins[1][0] == pytest.approx(1001.0 * 1e6)


def test_port_shards_merge_to_the_jax_packages_trace(tmp_path):
    """The JAX package's tracemerge reads the port's shards: the merged
    trace and summary are the port's, key for key."""
    root = str(tmp_path)
    _two_skewed_shards(root)
    assert tracemerge.merge_directory(root) == jtracemerge.merge_directory(root)


def test_cli_check_and_requirements(tmp_path, capsys):
    root = str(tmp_path)
    _two_skewed_shards(root)
    assert tracemerge.main(["--dir", root, "--check", "--require-span", "node_launch",
                            "--require-event", "lease_expired", "--require-same-trace"]) == 0
    assert os.path.isfile(os.path.join(root, "trace.json"))
    assert tracemerge.main(["--dir", root, "--require-event", "never_happened"]) == 1
    assert "never_happened" in capsys.readouterr().err


def test_validate_rejects_unmatched_pairs():
    bad = {"traceEvents": [{"ph": "B", "name": "a", "pid": 1, "tid": 1, "ts": 1.0},
                           {"ph": "E", "name": "b", "pid": 1, "tid": 1, "ts": 2.0}]}
    assert any("does not match open B" in p for p in tracemerge.validate_chrome_trace(bad))
    dangling = {"traceEvents": [{"ph": "B", "name": "a", "pid": 1, "tid": 1, "ts": 1.0}]}
    assert any("unclosed B" in p for p in tracemerge.validate_chrome_trace(dangling))


def test_overlap_fraction_from_drawn_geometry():
    events = [{"ph": "X", "name": "comm_allreduce", "ts": 0.0, "dur": 10.0},
              {"ph": "X", "name": "comm_window", "ts": 2.0, "dur": 4.0},
              {"ph": "X", "name": "comm_window", "ts": 4.0, "dur": 4.0}]
    assert tracemerge.overlap_fraction(events) == pytest.approx(0.6)
    assert tracemerge.overlap_fraction([]) is None


def test_quantile_endpoint_and_trace_endpoint(trace_root):
    tracing.mint(proc="driver")
    with obs.span("step_compute"):
        pass
    reg = registry.Registry(enabled=True)
    h = reg.histogram("toy_seconds", buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.5, 3.0, 3.5):
        h.observe(v)
    srv = exporter.MetricsHTTPServer(reg.snapshot, host="127.0.0.1", port=0).start()
    try:
        base = "http://127.0.0.1:{}".format(srv.address[1])
        body = json.loads(urllib.request.urlopen(base + "/histograms.json", timeout=10).read())
        assert body["toy_seconds"]["count"] == 4
        assert 0.0 < body["toy_seconds"]["p50"] <= 2.0 < body["toy_seconds"]["p99"] <= 4.0
        trace_body = json.loads(urllib.request.urlopen(base + "/trace", timeout=10).read())
        assert trace_body["torn"] == 0
        assert any(r.get("kind") == "span" and r.get("name") == "step_compute"
                   for r in trace_body["records"])
    finally:
        srv.stop()
