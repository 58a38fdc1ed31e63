"""Tracing plane: flight-recorder ring, trace propagation, shard merging.

Covers the tracing contract end to end in one process: crash-safe CRC
framing (torn-tail prefix recovery, the registry-journal idiom), segment
rotation and ring pruning, fork-safe shard reopening, span identity
threading through ``obs.span``, NTP-style clock observation, and the
tracemerge Chrome-trace output — including the two-host skewed-clock
merge the whole plane exists for.
"""

import json
import os
import urllib.request

import pytest

from tensorflowonspark_tpu_torch import chaos, obs
from tensorflowonspark_tpu_torch.obs import exporter, flight, registry, tracemerge, tracing


@pytest.fixture
def trace_root(tmp_path, monkeypatch):
    root = str(tmp_path / "traces")
    tracing.reset()
    monkeypatch.setenv(flight.TRACE_DIR_ENV, root)
    yield root
    tracing.reset()


def _shard_records(root):
    """All records across all shards under ``root``, with their shard dir."""
    out = []
    for shard in flight.list_shards(root):
        records, torn = flight.read_shard(shard)
        out.append((shard, records, torn))
    return out


class TestFlightRecorder:
    def test_append_roundtrip_with_meta_header(self, tmp_path):
        rec = flight.FlightRecorder(str(tmp_path), "unit")
        rec.append({"kind": "event", "name": "hello", "ts": 1.0})
        rec.close()
        records, torn = flight.read_shard(rec.shard_dir)
        assert torn == 0
        assert records[0]["kind"] == "meta"
        assert records[0]["proc"] == "unit"
        assert records[-1] == {"kind": "event", "name": "hello", "ts": 1.0}

    def test_rotation_seals_and_prunes_oldest(self, tmp_path):
        rec = flight.FlightRecorder(
            str(tmp_path), "unit", max_segment_bytes=256, max_segments=2
        )
        for i in range(100):
            rec.append({"kind": "event", "name": "e{}".format(i), "ts": float(i)})
        rec.close()
        names = sorted(os.listdir(rec.shard_dir))
        sealed = [n for n in names if n.endswith(".jsonl")]
        assert len(sealed) <= 2  # ring bound holds
        assert sum(1 for n in names if n.endswith(".open")) == 1
        records, torn = flight.read_shard(rec.shard_dir)
        assert torn == 0
        # the *newest* history survives pruning
        kept = [r["name"] for r in records if r.get("kind") == "event"]
        assert kept[-1] == "e99"
        assert "e0" not in kept

    def test_torn_open_tail_keeps_intact_prefix(self, tmp_path):
        rec = flight.FlightRecorder(str(tmp_path), "unit")
        rec.append({"kind": "event", "name": "kept", "ts": 1.0})
        rec.append({"kind": "event", "name": "also-kept", "ts": 2.0})
        rec.close()
        (open_seg,) = [
            n for n in os.listdir(rec.shard_dir) if n.endswith(".open")
        ]
        path = os.path.join(rec.shard_dir, open_seg)
        with open(path, "a", encoding="utf-8") as f:
            f.write('deadbeef {"kind":"event","name":"torn"')  # no newline, bad crc
        records, torn = flight.read_shard(rec.shard_dir)
        assert torn == 1
        assert [r["name"] for r in records if r.get("kind") == "event"] == [
            "kept", "also-kept",
        ]

    def test_corrupt_mid_segment_line_discards_suffix(self, tmp_path):
        # After a framing failure, alignment can't be trusted: prefix only.
        rec = flight.FlightRecorder(str(tmp_path), "unit")
        rec.append({"kind": "event", "name": "a", "ts": 1.0})
        rec.close()
        (open_seg,) = [n for n in os.listdir(rec.shard_dir) if n.endswith(".open")]
        path = os.path.join(rec.shard_dir, open_seg)
        with open(path, "a", encoding="utf-8") as f:
            f.write("garbage line\n")
            f.write(flight._frame(json.dumps({"kind": "event", "name": "b"})))
        records, torn = flight.read_shard(rec.shard_dir)
        assert torn == 2
        assert [r.get("name") for r in records if r.get("kind") == "event"] == ["a"]

    def test_dump_appends_marker(self, tmp_path):
        rec = flight.FlightRecorder(str(tmp_path), "unit")
        rec.dump("chaos:feed.stall")
        rec.close()
        records, _ = flight.read_shard(rec.shard_dir)
        dumps = [r for r in records if r.get("kind") == "dump"]
        assert len(dumps) == 1
        assert dumps[0]["reason"] == "chaos:feed.stall"

    def test_forked_child_opens_own_shard_without_double_flush(self, tmp_path):
        rec = flight.FlightRecorder(str(tmp_path), "unit")
        rec.append({"kind": "event", "name": "parent-before", "ts": 1.0})
        pid = os.fork()
        if pid == 0:
            # child: the inherited recorder must re-home to a new shard
            try:
                rec.append({"kind": "event", "name": "child", "ts": 2.0})
                rec.close()
                os._exit(0)
            except BaseException:
                os._exit(1)
        _, status = os.waitpid(pid, 0)
        assert os.waitstatus_to_exitcode(status) == 0
        rec.append({"kind": "event", "name": "parent-after", "ts": 3.0})
        rec.close()
        shards = {os.path.basename(s): s for s in flight.list_shards(str(tmp_path))}
        assert len(shards) == 2  # parent shard + child shard
        names_by_shard = {
            base: [r.get("name") for r in flight.read_shard(path)[0]
                   if r.get("kind") == "event"]
            for base, path in shards.items()
        }
        parent_base = "{}-{}-unit".format(
            __import__("socket").gethostname(), os.getpid()
        )
        assert names_by_shard[parent_base] == ["parent-before", "parent-after"]
        (child_base,) = [b for b in shards if b != parent_base]
        # child's shard holds ONLY its own write — the parent's buffered
        # bytes were abandoned, not flushed into either file
        assert names_by_shard[child_base] == ["child"]


class TestTraceContext:
    def test_mint_is_idempotent_and_returns_env(self, trace_root):
        env1 = tracing.mint(proc="driver")
        env2 = tracing.mint(proc="driver")
        assert env1[tracing.TRACE_ENV] == env2[tracing.TRACE_ENV] == tracing.trace_id()
        assert env1[tracing.DIR_ENV] == trace_root
        assert len(env1[tracing.TRACE_ENV]) == 32

    def test_nested_spans_record_parent_chain(self, trace_root):
        tracing.mint(proc="driver")
        with obs.span("step_fetch"):
            with obs.span("step_compute"):
                pass
        flight.current().close()
        ((_, records, _),) = _shard_records(trace_root)
        spans = {r["name"]: r for r in records if r.get("kind") == "span"}
        assert set(spans) == {"step_fetch", "step_compute"}
        assert spans["step_compute"]["parent"] == spans["step_fetch"]["span"]
        assert spans["step_fetch"]["trace"] == tracing.trace_id()
        # the outer span's parent is the propagated root span
        assert spans["step_fetch"]["parent"] == tracing.current_span_id()

    def test_install_from_env_adopts_propagated_context(self, trace_root):
        env = {
            tracing.TRACE_ENV: "ab" * 16,
            tracing.PARENT_ENV: "cd" * 8,
            tracing.DIR_ENV: trace_root,
        }
        assert tracing.install_from_env("executor0", env=env)
        assert tracing.trace_id() == "ab" * 16
        assert os.environ[tracing.TRACE_ENV] == "ab" * 16
        tracing.event("lease_expired", executor=0)
        flight.current().close()
        ((shard, records, _),) = _shard_records(trace_root)
        assert "executor0" in os.path.basename(shard)
        (evt,) = [r for r in records if r.get("kind") == "event"]
        assert evt["trace"] == "ab" * 16
        assert evt["parent"] == "cd" * 8

    def test_observe_clock_keeps_min_rtt_sample(self, trace_root):
        tracing.mint(proc="executor")
        assert tracing.observe_clock(105.0, t0=100.0, t1=100.4) is not None
        first = tracing.clock_offset()
        # higher-RTT sample is rejected, offset unchanged
        assert tracing.observe_clock(200.0, t0=100.0, t1=101.0) is None
        assert tracing.clock_offset() == first
        # tighter RTT wins
        assert tracing.observe_clock(105.0, t0=100.0, t1=100.1) is not None
        assert abs(tracing.clock_offset() - (105.0 - 100.05)) < 1e-9
        flight.current().close()
        ((_, records, _),) = _shard_records(trace_root)
        clocks = [r for r in records if r.get("kind") == "clock"]
        assert len(clocks) == 2  # the rejected sample was never journaled

    def test_record_span_lands_on_named_track(self, trace_root):
        tracing.mint(proc="driver")
        tracing.record_span("comm_allreduce", ts=10.0, dur_s=0.5, track="comm")
        flight.current().close()
        ((_, records, _),) = _shard_records(trace_root)
        (span,) = [r for r in records if r.get("kind") == "span"]
        assert span["track"] == "comm"
        assert span["ts"] == 10.0 and span["dur_s"] == 0.5

    def test_chaos_record_dumps_flight_ring(self, trace_root):
        tracing.mint(proc="driver")
        chaos._record("feed.stall")
        flight.current().close()
        ((_, records, _),) = _shard_records(trace_root)
        dumps = [r for r in records if r.get("kind") == "dump"]
        assert any(d["reason"] == "chaos:feed.stall" for d in dumps)


class TestTraceMerge:
    def _make_two_skewed_shards(self, root):
        """A driver shard and an executor shard whose local clock runs 5 s
        behind the driver's; causal order is driver a -> executor b -> driver c."""
        drv = flight.FlightRecorder(root, "driver", trace_id="t" * 32)
        drv.append({"kind": "span", "name": "reservation_roundtrip",
                    "trace": "t" * 32, "span": "s1", "parent": None,
                    "ts": 1000.0, "dur_s": 0.5, "ok": True, "tid": 1})
        drv.append({"kind": "event", "name": "lease_expired",
                    "trace": "t" * 32, "span": "e1", "parent": "s1", "ts": 1002.0})
        drv.close()
        exe = flight.FlightRecorder(root, "executor0", trace_id="t" * 32)
        exe.set_clock_offset(5.0, rtt=0.01)  # local + 5.0 == driver time
        # locally 996.0 == 1001.0 driver time: between the two driver marks
        exe.append({"kind": "span", "name": "node_launch",
                    "trace": "t" * 32, "span": "s2", "parent": "s1",
                    "ts": 996.0, "dur_s": 0.25, "ok": True, "tid": 2})
        exe.close()
        return drv, exe

    def test_skewed_clocks_merge_into_ordered_timeline(self, tmp_path):
        root = str(tmp_path)
        self._make_two_skewed_shards(root)
        trace, summary = tracemerge.merge_directory(root)
        assert tracemerge.validate_chrome_trace(trace) == []
        assert summary["trace_ids"] == ["t" * 32]
        offsets = {s["shard"].split("-")[-1]: s["clock_offset_s"]
                   for s in summary["shards"]}
        assert offsets["driver"] == 0.0
        assert offsets["executor0"] == 5.0
        begins = [(e["ts"], e["name"]) for e in trace["traceEvents"]
                  if e.get("ph") in ("B", "i") and e.get("cat") != "dump"]
        begins.sort()
        assert [n for _, n in begins] == [
            "reservation_roundtrip", "node_launch", "lease_expired",
        ]
        # the executor span landed at driver time 1001.0
        assert begins[1][0] == pytest.approx(1001.0 * 1e6)

    def test_cli_check_and_requirements(self, tmp_path, capsys):
        root = str(tmp_path)
        self._make_two_skewed_shards(root)
        rc = tracemerge.main([
            "--dir", root, "--check",
            "--require-span", "node_launch",
            "--require-event", "lease_expired",
            "--require-same-trace",
        ])
        assert rc == 0
        assert os.path.isfile(os.path.join(root, "trace.json"))
        rc = tracemerge.main(["--dir", root, "--require-event", "never_happened"])
        assert rc == 1
        assert "never_happened" in capsys.readouterr().err

    def test_validate_rejects_unmatched_pairs(self):
        bad = {"traceEvents": [
            {"ph": "B", "name": "a", "pid": 1, "tid": 1, "ts": 1.0},
            {"ph": "E", "name": "b", "pid": 1, "tid": 1, "ts": 2.0},
        ]}
        problems = tracemerge.validate_chrome_trace(bad)
        assert any("does not match open B" in p for p in problems)
        dangling = {"traceEvents": [
            {"ph": "B", "name": "a", "pid": 1, "tid": 1, "ts": 1.0},
        ]}
        assert any(
            "unclosed B" in p
            for p in tracemerge.validate_chrome_trace(dangling)
        )

    def test_overlap_fraction_from_drawn_geometry(self):
        events = [
            {"ph": "X", "name": "comm_allreduce", "ts": 0.0, "dur": 10.0},
            {"ph": "X", "name": "comm_window", "ts": 2.0, "dur": 4.0},
            {"ph": "X", "name": "comm_window", "ts": 4.0, "dur": 4.0},
        ]
        # windows [2,6] and [4,8] merge to [2,8]: 6 of 10 units hidden
        assert tracemerge.overlap_fraction(events) == pytest.approx(0.6)
        assert tracemerge.overlap_fraction([]) is None


class TestRegistryAndExporter:
    def test_event_eviction_is_counted(self, monkeypatch):
        monkeypatch.setattr(registry, "MAX_EVENTS", 3)
        reg = registry.Registry(enabled=True)
        for i in range(5):
            reg.add_event({"i": i})
        snap = reg.snapshot()
        assert snap["counters"]["obs_events_dropped_total"]["value"] == 2
        assert [e["i"] for e in snap["events"]] == [2, 3, 4]

    def test_quantile_endpoint_and_trace_endpoint(self, trace_root):
        tracing.mint(proc="driver")
        with obs.span("step_compute"):
            pass
        reg = registry.Registry(enabled=True)
        h = reg.histogram("toy_seconds", buckets=(1.0, 2.0, 4.0))
        for v in (0.5, 1.5, 3.0, 3.5):
            h.observe(v)
        srv = exporter.MetricsHTTPServer(
            reg.snapshot, host="127.0.0.1", port=0
        ).start()
        try:
            base = "http://127.0.0.1:{}".format(srv.address[1])
            body = json.loads(
                urllib.request.urlopen(base + "/histograms.json", timeout=10).read()
            )
            assert body["toy_seconds"]["count"] == 4
            assert 0.0 < body["toy_seconds"]["p50"] <= 2.0
            assert 2.0 < body["toy_seconds"]["p99"] <= 4.0
            trace_body = json.loads(
                urllib.request.urlopen(base + "/trace", timeout=10).read()
            )
            assert trace_body["torn"] == 0
            assert any(
                r.get("kind") == "span" and r.get("name") == "step_compute"
                for r in trace_body["records"]
            )
        finally:
            srv.stop()

    def test_histogram_quantile_interpolates(self):
        snap = {"count": 10, "sum": 0.0,
                "buckets": [[1.0, 5], [2.0, 5]]}
        assert exporter.histogram_quantile(snap, 0.5) == pytest.approx(1.0)
        assert exporter.histogram_quantile(snap, 0.75) == pytest.approx(1.5)
        assert exporter.histogram_quantile({"count": 0, "buckets": []}, 0.5) is None
