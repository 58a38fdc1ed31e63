"""Merge per-process flight shards into one Chrome-trace-event JSON.

``python -m tensorflowonspark_tpu_torch.obs.tracemerge --dir $TOS_TRACE_DIR --out
trace.json`` walks every shard under the trace root
(:func:`tensorflowonspark_tpu_torch.obs.flight.list_shards`), aligns each shard's
wall clock onto the driver's, and emits a single ``{"traceEvents": [...]}``
document loadable by Perfetto / ``chrome://tracing``.

Clock alignment.  The driver's clock is the reference (offset 0).  Every
other shard resolves its offset in priority order: the lowest-RTT ``clock``
record journaled by :func:`tensorflowonspark_tpu_torch.obs.tracing.observe_clock`
(NTP-style midpoint estimate from the reservation REG round-trip), else the
``clock_off`` carried by the newest segment ``meta`` header (inherited by
same-host children via ``TOS_TRACE_CLOCK_OFF``), else 0.

Track layout.  Each shard becomes one Chrome *process* (``M``
``process_name`` metadata from its ``meta`` header).  Context-manager spans
are emitted as matched ``B``/``E`` pairs on their recording thread's track;
retroactive spans carrying a ``track`` label (the ``BucketedOverlap`` comm
spans) land on a dedicated named track as ``X`` complete events, so the
comm/compute overlap the ``comm_overlap_fraction`` gauge reports is directly
visible — and :func:`overlap_fraction` recomputes it from the drawn spans
alone so the two can be cross-checked.

Nesting repair.  Span starts are wall-clock but durations are monotonic
(NTP steps must not corrupt durations — see ``obs/trace.py``), so a child's
computed end can jitter past its parent's by microseconds.  Before emitting
``B``/``E`` pairs the merger clamps each span into its enclosing interval,
restoring a proper bracket sequence per track.
"""

import argparse
import json
import os
import sys

from tensorflowonspark_tpu_torch.obs import flight

#: synthetic Chrome tid for retro comm-track spans (real thread ids are
#: os-assigned and never this large on Linux, whose pid space caps at 2^22)
COMM_TID = 9_000_000
WINDOW_TID = 9_000_001

_TRACK_TIDS = {"comm": COMM_TID, "comm_window": WINDOW_TID}
_TRACK_NAMES = {
    COMM_TID: "comm (bucketed all-reduce)",
    WINDOW_TID: "comm overlap windows",
}


def resolve_offset(records):
    """The shard's wall-clock offset onto driver time (seconds to add)."""
    best_off, best_rtt = None, None
    meta_off = 0.0
    for rec in records:
        kind = rec.get("kind")
        if kind == "clock":
            rtt = rec.get("rtt_s")
            if best_rtt is None or (rtt is not None and rtt < best_rtt):
                best_rtt = rtt
                best_off = rec.get("offset_s", 0.0)
        elif kind == "meta":
            meta_off = rec.get("clock_off", meta_off) or 0.0
    return float(best_off if best_off is not None else meta_off)


def _clamp_nesting(spans):
    """Clamp each span's end into its enclosing span so the B/E bracket
    sequence is well formed despite wall/monotonic micro-jitter."""
    spans = sorted(spans, key=lambda s: (s["_b"], -(s["_e"] - s["_b"])))
    stack = []
    for s in spans:
        while stack and s["_b"] >= stack[-1]["_e"]:
            stack.pop()
        if stack and s["_e"] > stack[-1]["_e"]:
            s["_e"] = stack[-1]["_e"]
        if stack and s["_b"] < stack[-1]["_b"]:
            s["_b"] = stack[-1]["_b"]
        stack.append(s)
    return spans


def _shard_events(records, pid, offset):
    """Chrome events for one shard (pid = synthetic process id)."""
    meta = next((r for r in records if r.get("kind") == "meta"), {})
    label = "{}:{} pid={}".format(
        meta.get("host", "?"), meta.get("proc", "?"), meta.get("pid", "?")
    )
    events = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": label}},
    ]
    named_tids = set()
    by_tid = {}
    for rec in records:
        kind = rec.get("kind")
        ts_us = (rec.get("ts", 0.0) + offset) * 1e6
        if kind == "span":
            track = rec.get("track")
            if track:
                tid = _TRACK_TIDS.get(track, COMM_TID)
                if tid not in named_tids:
                    named_tids.add(tid)
                    events.append({
                        "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                        "args": {"name": _TRACK_NAMES.get(tid, track)},
                    })
                events.append({
                    "ph": "X", "name": rec.get("name", "?"), "cat": track,
                    "pid": pid, "tid": tid, "ts": ts_us,
                    "dur": max(0.0, rec.get("dur_s", 0.0)) * 1e6,
                    "args": _span_args(rec),
                })
            else:
                tid = int(rec.get("tid", 0))
                by_tid.setdefault(tid, []).append({
                    "name": rec.get("name", "?"),
                    "_b": ts_us,
                    "_e": ts_us + max(0.0, rec.get("dur_s", 0.0)) * 1e6,
                    "args": _span_args(rec),
                })
        elif kind == "event":
            events.append({
                "ph": "i", "name": rec.get("name", "?"), "cat": "event",
                "pid": pid, "tid": 0, "ts": ts_us, "s": "p",
                "args": _span_args(rec),
            })
        elif kind == "dump":
            events.append({
                "ph": "i", "name": "flight_dump", "cat": "dump",
                "pid": pid, "tid": 0, "ts": ts_us, "s": "p",
                "args": {"reason": rec.get("reason", "?")},
            })
    for tid, spans in by_tid.items():
        for s in _clamp_nesting(spans):
            args = s["args"]
            events.append({"ph": "B", "name": s["name"], "pid": pid, "tid": tid,
                           "ts": s["_b"], "args": args, "_d": s["_e"] - s["_b"]})
            events.append({"ph": "E", "name": s["name"], "pid": pid, "tid": tid,
                           "ts": s["_e"], "_d": s["_e"] - s["_b"]})
    return events


def _span_args(rec):
    args = dict(rec.get("attrs") or {})
    for key in ("trace", "span", "parent", "ok"):
        if rec.get(key) is not None:
            args[key] = rec[key]
    return args


def _sort_key(evt):
    # per-track emit order: E before B at equal ts (close, then open);
    # among Bs the longer span opens first, among Es the shorter closes first
    ph = evt.get("ph")
    dur = evt.get("_d", 0.0)
    if ph == "E":
        return (evt.get("ts", 0.0), 0, dur)
    if ph == "B":
        return (evt.get("ts", 0.0), 1, -dur)
    return (evt.get("ts", 0.0), 1, 0.0)


def merge_directory(root):
    """Merge every shard under ``root``.

    Returns ``(trace, summary)`` — ``trace`` is the Chrome JSON document,
    ``summary`` a per-shard accounting (offsets, record/torn counts, trace
    ids seen).
    """
    events = []
    shards = []
    trace_ids = set()
    for pid, shard_dir in enumerate(flight.list_shards(root), start=1):
        records, torn = flight.read_shard(shard_dir)
        offset = resolve_offset(records)
        for rec in records:
            if rec.get("trace"):
                trace_ids.add(rec["trace"])
        shards.append({
            "shard": os.path.basename(shard_dir),
            "pid": pid,
            "records": len(records),
            "torn": torn,
            "clock_offset_s": offset,
        })
        events.extend(_shard_events(records, pid, offset))
    metas = [e for e in events if e.get("ph") == "M"]
    rest = sorted((e for e in events if e.get("ph") != "M"), key=_sort_key)
    for e in rest:
        e.pop("_d", None)
    trace = {"traceEvents": metas + rest, "displayTimeUnit": "ms"}
    summary = {
        "shards": shards,
        "events": len(metas) + len(rest),
        "trace_ids": sorted(trace_ids),
        "overlap_fraction": overlap_fraction(trace["traceEvents"]),
    }
    return trace, summary


def overlap_fraction(events):
    """Recompute comm/compute overlap from the drawn comm-track spans: the
    fraction of ``comm_allreduce`` busy time lying inside some
    ``comm_window`` interval — the same estimate ``BucketedOverlap`` folds
    into the ``comm_overlap_fraction`` gauge, but derived purely from the
    merged timeline so the gauge can be corroborated visually AND
    numerically.  None when no comm spans were recorded."""
    comm, windows = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        iv = (e["ts"], e["ts"] + e.get("dur", 0.0))
        if e.get("name") == "comm_allreduce":
            comm.append(iv)
        elif e.get("name") == "comm_window":
            windows.append(iv)
    if not comm:
        return None
    # merge the window set, then intersect
    windows.sort()
    merged = []
    for b, e in windows:
        if merged and b <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([b, e])
    busy = sum(e - b for b, e in comm)
    hidden = 0.0
    for b, e in comm:
        for wb, we in merged:
            lo, hi = max(b, wb), min(e, we)
            if hi > lo:
                hidden += hi - lo
    return (hidden / busy) if busy > 0 else None


def validate_chrome_trace(trace):
    """Validate the merged document against the Chrome trace-event schema
    subset the CI leg asserts: required keys per event, monotone ``ts`` per
    (pid, tid) track, and matched ``B``/``E`` pairs.  Returns a list of
    problem strings (empty = valid)."""
    problems = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    last_ts = {}
    stacks = {}
    for i, e in enumerate(events):
        ph = e.get("ph")
        if ph is None or "name" not in e or "pid" not in e:
            problems.append("event {}: missing required key (ph/name/pid)".format(i))
            continue
        if ph == "M":
            continue
        if "tid" not in e or "ts" not in e:
            problems.append("event {}: missing required key (tid/ts)".format(i))
            continue
        key = (e["pid"], e["tid"])
        if e["ts"] < last_ts.get(key, float("-inf")):
            problems.append(
                "event {}: ts {} not monotone on track {}".format(i, e["ts"], key)
            )
        last_ts[key] = e["ts"]
        if ph == "B":
            stacks.setdefault(key, []).append(e["name"])
        elif ph == "E":
            stack = stacks.setdefault(key, [])
            if not stack:
                problems.append("event {}: E {!r} with empty stack".format(i, e["name"]))
            elif stack[-1] != e["name"]:
                problems.append(
                    "event {}: E {!r} does not match open B {!r}".format(
                        i, e["name"], stack[-1]
                    )
                )
                stack.pop()
            else:
                stack.pop()
        elif ph == "X":
            if e.get("dur", 0) < 0:
                problems.append("event {}: negative dur".format(i))
    for key, stack in stacks.items():
        if stack:
            problems.append("track {}: unclosed B spans {}".format(key, stack))
    return problems


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m tensorflowonspark_tpu_torch.obs.tracemerge",
        description="merge flight-recorder shards into one Chrome trace JSON",
    )
    parser.add_argument("--dir", default=os.environ.get(flight.TRACE_DIR_ENV),
                        help="trace root (default: $TOS_TRACE_DIR)")
    parser.add_argument("--out", default=None,
                        help="output path (default: <dir>/trace.json)")
    parser.add_argument("--check", action="store_true",
                        help="validate the merged trace; exit 1 on schema problems")
    parser.add_argument("--summary", action="store_true",
                        help="print the merge summary JSON to stdout")
    parser.add_argument("--require-span", action="append", default=[],
                        metavar="NAME", help="fail unless a span NAME is present")
    parser.add_argument("--require-event", action="append", default=[],
                        metavar="NAME", help="fail unless an instant event NAME is present")
    parser.add_argument("--require-same-trace", action="store_true",
                        help="fail unless every shard record shares one trace_id")
    args = parser.parse_args(argv)
    if not args.dir:
        parser.error("--dir not given and TOS_TRACE_DIR unset")
    trace, summary = merge_directory(args.dir)
    out = args.out or os.path.join(args.dir, "trace.json")
    with open(out, "w", encoding="utf-8") as f:
        json.dump(trace, f)
    print("tracemerge: {} events from {} shard(s) -> {}".format(
        summary["events"], len(summary["shards"]), out))
    failures = []
    if args.check:
        failures.extend(validate_chrome_trace(trace))
    names = {(e.get("ph"), e.get("name")) for e in trace["traceEvents"]}
    spans_present = {n for ph, n in names if ph in ("B", "X")}
    events_present = {n for ph, n in names if ph == "i"}
    for want in args.require_span:
        if want not in spans_present:
            failures.append("required span {!r} not present".format(want))
    for want in args.require_event:
        if want not in events_present:
            failures.append("required event {!r} not present".format(want))
    if args.require_same_trace and len(summary["trace_ids"]) != 1:
        failures.append(
            "expected exactly one trace_id, saw {}".format(summary["trace_ids"])
        )
    if args.summary:
        print(json.dumps(summary, sort_keys=True))
    if failures:
        for f in failures:
            print("tracemerge FAILED: {}".format(f), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
