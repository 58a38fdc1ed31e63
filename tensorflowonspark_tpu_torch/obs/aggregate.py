"""Driver-side aggregation: executor registries → one cluster view.

Transport is the EXISTING per-executor TFManager channel (the same k/v store
the heartbeat and state machine ride): nothing new listens on the network, and
the driver can already reach every node's channel (or falls back per
TFCluster's NAT story — unreachable channels simply contribute no metrics).

Two publication shapes, matching the two process lifetimes in the runtime:

* :class:`SnapshotPublisher` — the long-lived jax child overwrites its full
  registry snapshot under ``obs_snapshot`` every interval. Overwrite is
  idempotent: the child's registry is cumulative, so the newest snapshot
  supersedes older ones.
* :func:`accumulate_to_channel` — short-lived Spark tasks (feed/launch tasks)
  MERGE a private registry into ``obs_feeder`` at task end. Tasks on one
  executor are serialized (the one-concurrent-task-per-executor invariant the
  feed plane already holds), so read-merge-write needs no channel-side lock.
  Tasks must use a PRIVATE registry: the executor process outlives tasks, and
  accumulating the process-global registry twice would double-count.

Snapshots cross the channel as JSON strings — same no-code-execution stance
as the reservation control plane (executors should not be able to unpickle
arbitrary objects into the driver).

Merge semantics (:func:`merge_snapshots`):

* counters: summed (every counter is a rate-able total);
* histograms: bucket-wise summed when bounds agree (snapshots from mixed
  bucket layouts keep the first layout and still sum count/sum);
* gauges: summed across sources — "cluster feed-queue depth" is the sum of
  per-node depths; per-node values stay visible in ``TFCluster.metrics()``'s
  ``nodes`` section;
* events: concatenated, ordered by wall time, bounded to the newest
  ``registry.MAX_EVENTS``.
"""

import json
import logging
import os
import threading

from tensorflowonspark_tpu_torch.obs import registry as _registry

logger = logging.getLogger(__name__)

#: channel key written by the jax child's periodic publisher
CHANNEL_KEY = "obs_snapshot"
#: channel key accumulated by short-lived feeder/launch tasks
FEEDER_KEY = "obs_feeder"
#: channel key overwritten by an elected heartbeat aggregator's private
#: registry (registry.HeartbeatAggregator) — overwrite semantics like
#: CHANNEL_KEY, but a separate lane because the aggregator thread outlives
#: the launch task and must not double-count the child's snapshot
AGGREGATOR_KEY = "obs_aggregator"

#: seconds between child snapshot publications
PUBLISH_INTERVAL = float(os.environ.get("TOS_OBS_PUBLISH_INTERVAL", "2"))


def merge_snapshots(snapshots, gauges="sum"):
    """Merge registry snapshots (dicts, as returned by Registry.snapshot).

    ``gauges="sum"`` is the cross-NODE semantic (cluster queue depth = sum of
    per-node depths); ``gauges="last"`` is the same-node-over-TIME semantic
    used by :func:`accumulate_to_channel` (a fresh feed wave's queue depth
    replaces the previous wave's, it doesn't add to it).
    """
    gauge_last = gauges == "last"
    counters, gauges, histograms, events = {}, {}, {}, []
    ts = 0.0
    for snap in snapshots:
        if not snap:
            continue
        ts = max(ts, snap.get("ts", 0.0))
        for name, c in (snap.get("counters") or {}).items():
            dst = counters.setdefault(name, {"value": 0.0, "help": c.get("help", "")})
            dst["value"] += c.get("value", 0.0)
        for name, g in (snap.get("gauges") or {}).items():
            dst = gauges.setdefault(name, {"value": 0.0, "help": g.get("help", "")})
            if gauge_last:
                dst["value"] = g.get("value", 0.0)
            else:
                dst["value"] += g.get("value", 0.0)
        for name, h in (snap.get("histograms") or {}).items():
            dst = histograms.get(name)
            if dst is None:
                histograms[name] = {
                    "buckets": [list(b) for b in h.get("buckets") or []],
                    "sum": h.get("sum", 0.0),
                    "count": h.get("count", 0),
                    "help": h.get("help", ""),
                }
                continue
            dst["sum"] += h.get("sum", 0.0)
            dst["count"] += h.get("count", 0)
            src_buckets = h.get("buckets") or []
            if [b[0] for b in dst["buckets"]] == [b[0] for b in src_buckets]:
                for i, (_le, n) in enumerate(src_buckets):
                    dst["buckets"][i][1] += n
            # mismatched bucket layouts: keep the first layout; sum/count
            # above stay correct, per-bucket detail is best-effort
        events.extend(snap.get("events") or [])
    events.sort(key=lambda e: e.get("ts", 0.0))
    return {
        "ts": ts,
        "counters": counters,
        "gauges": gauges,
        "histograms": histograms,
        "events": events[-_registry.MAX_EVENTS:],
    }


def publish_to_channel(mgr, registry=None, key=CHANNEL_KEY):
    """Overwrite this process's registry snapshot on the executor channel."""
    reg = registry if registry is not None else _registry.get_registry()
    mgr.set(key, json.dumps(reg.snapshot()))


def accumulate_to_channel(mgr, registry, key=FEEDER_KEY):
    """Merge a (private, per-task) registry into the channel's accumulated
    snapshot. See module docstring for why this must be a private registry."""
    snap = registry.snapshot()
    try:
        existing = mgr.get(key)
        prior = json.loads(existing) if existing else None
    except (ValueError, TypeError):
        prior = None  # corrupt/foreign payload: start over
    merged = merge_snapshots([prior, snap], gauges="last") if prior else snap
    mgr.set(key, json.dumps(merged))


def read_channel_snapshots(mgr, keys=(CHANNEL_KEY, FEEDER_KEY, AGGREGATOR_KEY)):
    """All snapshots one executor channel holds (child + feeder +
    heartbeat-aggregator lanes)."""
    snaps = []
    for key in keys:
        try:
            raw = mgr.get(key)
            if raw:
                snaps.append(json.loads(raw))
        except (ValueError, TypeError):
            continue
    return snaps


class SnapshotPublisher:
    """Daemon thread publishing the jax child's registry every
    ``interval`` seconds (and once at :meth:`stop`), with the same
    die-quietly-on-dead-channel policy as the heartbeat thread."""

    def __init__(self, mgr, registry=None, interval=None, key=CHANNEL_KEY):
        self._mgr = mgr
        self._registry = registry if registry is not None else _registry.get_registry()
        self._interval = PUBLISH_INTERVAL if interval is None else float(interval)
        self._key = key
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        if not self._registry._enabled:
            return self  # disabled: publish nothing, spin nothing
        self._thread = threading.Thread(
            target=self._run, name="tos-obs-publisher", daemon=True
        )
        self._thread.start()
        return self

    def _run(self):
        failures = 0
        while not self._stop.wait(self._interval):
            try:
                publish_to_channel(self._mgr, self._registry, self._key)
                failures = 0
            except Exception:
                failures += 1
                if failures >= 5:
                    return  # channel stayed dead: executor is going away
        try:  # final flush so short runs publish at least once
            publish_to_channel(self._mgr, self._registry, self._key)
        except Exception:
            pass

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
