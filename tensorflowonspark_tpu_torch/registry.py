"""Crash-survivable control plane: lease-based membership + heartbeat trees.

Before this module the cluster's membership truth was scattered: the
reservation server held a one-shot assembly snapshot, the watchdog kept a
private ``last_beat`` dict of ad-hoc ``mgr.get("heartbeat")`` polls, and the
recovery ladder threaded blacklist *sets* by hand between attempts. A driver
restart lost all three at once, killing every in-flight job even though the
executors, jax children, and checkpoints were all healthy (ROADMAP open
item 5). This module makes membership a first-class, journaled object with
three tiers:

**Lease-based membership** (:class:`MembershipRegistry`). Every executor
holds a TTL lease granted at registration and renewed each time the driver
observes its heartbeat counter *advance* (a re-read of the same beat value
is not progress — that is exactly how a SIGKILLed child looks). Liveness
(:meth:`~MembershipRegistry.expire_stale`), the blacklist
(:meth:`~MembershipRegistry.blacklist` /
:meth:`~MembershipRegistry.is_blacklisted`) and the role map
(:meth:`~MembershipRegistry.begin_generation`) all read from this one
registry; lease expiry feeds :func:`tensorflowonspark_tpu_torch.elastic.classify_failure`
as a first-class ``lease_expired`` event. A node that never beat at all is
exempt from expiry (slow child startup is the launch timeout's concern, not
a lease violation) — parity with the historical watchdog.

**Heartbeat aggregation trees** (:func:`plan_aggregation_tree` +
:class:`HeartbeatAggregator`). With N executors the driver used to open N
channel connections per watchdog cycle. Instead, ~sqrt(N) executors are
deterministically elected aggregators; each polls its group's channels
every window and publishes one JSON summary (beats, final statuses, error
flags) on its *own* channel under :data:`WINDOW_KEY`, so the steady-state
driver fan-in is O(sqrt N) sockets. The election is a pure function of the
assembled cluster info, so driver and executors agree without another
round-trip. Members whose aggregator goes quiet fall back to direct driver
polls — the tree is an optimization, never a single point of failure.

**Driver-restart survivability**. Every membership transition (join, lease
renew/expire, blacklist, role map, cluster epoch) is journaled under
``journal_dir``: an append-only ``journal.log`` of CRC-framed JSON lines,
compacted into a ``REGISTRY.json`` manifest via the same tmp+fsync+rename
discipline proven by :mod:`tensorflowonspark_tpu_torch.ckpt.manifest` (the
previous manifest is retained as ``REGISTRY.json.prev``, and the journal is
truncated only *after* a successful manifest rename — so a manifest torn
mid-publish always leaves prev-manifest + journal able to reconstruct the
full state). :meth:`MembershipRegistry.recover` replays manifest + journal,
re-adopts live executors whose leases have not yet expired on the wall
clock (they keep training through the driver outage), and resumes under an
**incremented epoch**: any still-running pre-crash driver instance is
fenced — its next durable commit sees the higher on-disk epoch and raises
:class:`StaleEpochError` instead of clobbering the new generation's
journal.

Chaos sites: ``control.lease_delay`` (stall a renewal — benign),
``control.journal_tear`` (tear the manifest publish, or with
``target: "journal"`` a journal append — recovery must fall back to the
previous committed manifest), and ``control.driver_crash`` (consulted by
the TFCluster watchdog: drop the in-memory registry mid-train and recover
from the journal, as a restarted driver would).

Metrics (driver-global unless noted; all in ``TFCluster.metrics()``):
``registry_leases_active`` / ``registry_epoch`` gauges,
``registry_lease_expirations_total`` / ``registry_journal_commits_total``
counters, and ``heartbeat_agg_windows_total`` (counted aggregator-side in a
private registry published over the channel's :data:`AGGREGATOR_KEY` lane).
"""

import json
import logging
import math
import os
import threading
import time
import zlib

from tensorflowonspark_tpu_torch import chaos, durable, obs, resilience
from tensorflowonspark_tpu_torch.obs import aggregate as obs_aggregate
from tensorflowonspark_tpu_torch.obs import registry as obs_registry

logger = logging.getLogger(__name__)

#: committed state snapshot (the durable truth after compaction)
MANIFEST_NAME = "REGISTRY.json"
#: previous committed manifest, kept so a torn publish can fall back
PREV_MANIFEST_NAME = "REGISTRY.json.prev"
#: append-only transition log since the last manifest compaction
JOURNAL_NAME = "journal.log"
#: manifest format version (bump on incompatible layout changes)
VERSION = 1

#: default lease TTL: seconds a member may go without an observed heartbeat
#: advance before its lease expires (same knob as the historical watchdog)
DEFAULT_TTL = float(os.environ.get("TOS_HEARTBEAT_STALE", "30"))

#: journal records between manifest compactions
MANIFEST_EVERY = int(os.environ.get("TOS_REGISTRY_MANIFEST_EVERY", "16"))

#: channel key an aggregator publishes its per-window summary under
WINDOW_KEY = "heartbeat_window"
#: channel obs lane for the aggregator thread's private registry (overwrite
#: semantics, like the jax child's obs_snapshot lane)
AGGREGATOR_KEY = obs_aggregate.AGGREGATOR_KEY

#: seconds per aggregation window (defaults to the heartbeat interval: one
#: summary per beat generation)
WINDOW_SECS = float(
    os.environ.get("TOS_HEARTBEAT_WINDOW", os.environ.get("TOS_HEARTBEAT_INTERVAL", "2"))
)

#: ops that are fsynced at append time (a lost renew only ages a lease;
#: a lost join/expire/blacklist/epoch would corrupt recovery decisions)
_DURABLE_OPS = frozenset({"epoch", "join", "leave", "expire", "blacklist", "forgive", "role"})


class StaleEpochError(Exception):
    """A durable commit was refused because the on-disk manifest carries a
    higher epoch: another (newer) driver generation owns the journal now.
    The fenced writer must stop — its view of the cluster is history."""


# ---------------------------------------------------------------------------
# aggregation-tree election (pure functions shared by driver and executors)
# ---------------------------------------------------------------------------


def aggregation_enabled(num_nodes):
    """Whether the heartbeat aggregation tree is on for ``num_nodes``.

    ``TOS_HEARTBEAT_AGG``: ``"0"`` forces off, ``"1"`` forces on, anything
    else (default) enables it from ``TOS_HEARTBEAT_AGG_MIN`` nodes up.
    """
    mode = os.environ.get("TOS_HEARTBEAT_AGG", "auto")
    if mode == "0":
        return False
    if mode == "1":
        return num_nodes > 0
    return num_nodes >= int(os.environ.get("TOS_HEARTBEAT_AGG_MIN", "2"))


def window_coverage(summary, member_eids):
    """Which of ``member_eids`` one aggregator window summary actually covers.

    Returns ``(statuses, beats, flagged)``, the first two keyed by int
    executor id. A member appearing in NONE of them was unreachable from the
    aggregator (executor process gone) or has not produced a beat yet: it is
    NOT covered, and the driver must fall back to direct-polling it — a
    lease renewal inferred from a summary that carries no data for the
    member would keep a dead executor alive forever.
    """
    statuses_raw = summary.get("status") or {}
    beats_raw = summary.get("beats") or {}
    flagged = set(summary.get("errors") or [])
    statuses, beats = {}, {}
    for eid in member_eids:
        seid = str(eid)
        if seid in statuses_raw:
            statuses[eid] = statuses_raw[seid]
        elif seid in beats_raw:
            beats[eid] = beats_raw[seid]
    return statuses, beats, flagged & set(member_eids)


def plan_aggregation_tree(rows):
    """Elect aggregators: ``{aggregator_executor_id: [member ids...]}``.

    Pure function of the assembled cluster info (rows with a reachable
    channel), so every process computes the same tree without coordination:
    executor ids are sorted and chunked into ~sqrt(N) groups; the lowest id
    of each group aggregates it (itself included).
    """
    eids = sorted(r["executor_id"] for r in rows if r.get("manager_addr"))
    if not eids:
        return {}
    k = max(1, math.isqrt(len(eids)))
    size = -(-len(eids) // k)  # ceil division
    tree = {}
    for start in range(0, len(eids), size):
        group = eids[start:start + size]
        tree[group[0]] = group
    return tree


# ---------------------------------------------------------------------------
# the membership registry
# ---------------------------------------------------------------------------


class MembershipRegistry:
    """The cluster's single membership truth, journaled for driver restarts.

    Thread-safe: the reservation server's REG handler joins members, the
    watchdog renews/expires leases, and the recovery ladder reads/writes the
    blacklist, all concurrently. The wall clock (injectable ``clock``) is
    used for lease ages because journaled timestamps must stay comparable
    across a driver restart — a monotonic clock does not survive a process.

    ``journal_dir=None`` keeps the registry purely in-memory (tests, callers
    that do not want restart survivability); every durable-path method then
    degrades to the in-memory transition alone.
    """

    def __init__(self, ttl=None, journal_dir=None, clock=time.time,
                 manifest_every=None):
        self.ttl = DEFAULT_TTL if ttl is None else float(ttl)
        self.journal_dir = (
            os.path.abspath(os.path.expanduser(journal_dir)) if journal_dir else None
        )
        self._clock = clock
        self._manifest_every = MANIFEST_EVERY if manifest_every is None else int(manifest_every)
        self._lock = threading.Lock()
        self._epoch = 0
        self._seq = 0
        self._members = {}    # eid -> {"job","task","joined_at","renewed_at","beat","state"}
        self._roles = {}      # eid -> [job, task_index]
        self._blacklist = {}  # eid -> reason
        self._target_size = None  # the ladder's journaled plan size
        self._fenced = False
        self._records_since_manifest = 0
        self._manifest_stat = None  # (mtime_ns, size) last seen — cheap fence probe
        if self.journal_dir:
            os.makedirs(self.journal_dir, exist_ok=True)
        self._publish_gauges()

    # -- public read surface -------------------------------------------------

    @property
    def epoch(self):
        with self._lock:
            return self._epoch

    @property
    def target_size(self):
        """The executor count the last generation was planned at (journaled
        with the epoch record, so a restarted driver knows whether the
        ladder had shrunk — and how far regrow has to go). None until a
        generation declares one."""
        with self._lock:
            return self._target_size

    def members(self):
        """eid -> member record (copy), every state included."""
        with self._lock:
            return {eid: dict(m) for eid, m in self._members.items()}

    def live_members(self):
        """eids holding a live (unexpired, unreleased) lease, sorted."""
        with self._lock:
            return sorted(e for e, m in self._members.items() if m["state"] == "live")

    def leases_active(self):
        with self._lock:
            return sum(1 for m in self._members.values() if m["state"] == "live")

    def roles(self):
        """eid -> (job_name, task_index) for every assigned role."""
        with self._lock:
            return {eid: tuple(r) for eid, r in self._roles.items()}

    def role_map(self):
        """``"job:task_index"`` -> eid — the shape ``elastic.classify_failure``
        attributes watchdog messages with."""
        with self._lock:
            return {"{}:{}".format(j, t): eid for eid, (j, t) in self._roles.items()}

    def blacklisted(self):
        with self._lock:
            return sorted(self._blacklist)

    def is_blacklisted(self, executor_id):
        with self._lock:
            return executor_id in self._blacklist

    def lease_age(self, executor_id):
        """Seconds since the member's lease was last renewed, or None."""
        with self._lock:
            m = self._members.get(executor_id)
            return None if m is None else self._clock() - m["renewed_at"]

    # -- transitions ---------------------------------------------------------

    def begin_generation(self, template=None, reason="launch", target_size=None):
        """Open a new cluster generation: epoch += 1, membership cleared,
        roles set from ``template`` (eid -> (job, task_index)). Called once
        per ``TFCluster.run`` attempt — a relaunch is a new generation, and
        the epoch gap is what fences any stale writer from the old one.

        ``target_size`` journals the executor count this generation was
        planned at (defaults to the template size), making the ladder's
        shrink/regrow position durable across a driver restart."""
        with self._lock:
            self._epoch += 1
            self._members = {}
            if template is not None:
                self._roles = {eid: [j, t] for eid, (j, t) in template.items()}
            if target_size is not None:
                self._target_size = int(target_size)
            elif template is not None:
                self._target_size = len(template)
            rec = {"op": "epoch", "epoch": self._epoch, "reason": reason,
                   "roles": {str(e): list(r) for e, r in self._roles.items()}}
            if self._target_size is not None:
                rec["target"] = self._target_size
            self._journal_locked(rec)
            epoch = self._epoch
        self._publish_gauges()
        logger.info("registry: generation epoch=%d (%s)", epoch, reason)
        return epoch

    def assign_role(self, executor_id, job_name, task_index):
        with self._lock:
            self._roles[executor_id] = [job_name, int(task_index)]
            self._journal_locked(
                {"op": "role", "eid": executor_id, "job": job_name, "task": int(task_index)}
            )

    def join(self, executor_id, job_name=None, task_index=None, meta=None):
        """Grant (or idempotently refresh) a membership lease. REG retries
        and driver-side re-adoption both land here, so join must be safe to
        repeat."""
        meta = meta or {}
        job = job_name if job_name is not None else meta.get("job_name")
        task = task_index if task_index is not None else meta.get("task_index")
        with self._lock:
            now = self._clock()
            m = self._members.get(executor_id)
            if m is None:
                m = self._members[executor_id] = {
                    "job": job, "task": task, "joined_at": now,
                    "renewed_at": now, "journaled_at": now, "beat": None,
                    "state": "live",
                }
            else:
                m["state"] = "live"
                m["renewed_at"] = now
                if job is not None:
                    m["job"], m["task"] = job, task
            if job is not None:
                self._roles[executor_id] = [job, int(task or 0)]
            self._journal_locked(
                {"op": "join", "eid": executor_id, "job": job,
                 "task": task, "t": now}
            )
        self._publish_gauges()

    def renew(self, executor_id, beat=None):
        """Renew a lease from an observed heartbeat. Returns True when the
        lease actually renewed — i.e. the beat *advanced* (or no beat value
        is used). Re-reading a dead child's frozen counter renews nothing."""
        if chaos.active:
            chaos.delay("control.lease_delay")
        renewed = False
        with self._lock:
            m = self._members.get(executor_id)
            if m is None or m["state"] == "left":
                return False
            if beat is not None and m["beat"] == beat:
                return False
            now = self._clock()
            first_beat = m["beat"] is None and beat is not None
            m["renewed_at"] = now
            if beat is not None:
                m["beat"] = beat
            if m["state"] == "expired":
                # the node came back (long flap): re-adopt rather than
                # insist on the funeral
                m["state"] = "live"
            renewed = True
            # coalesce renew journaling: one durable record per ttl/4 per
            # member bounds journal growth without aging recovered leases by
            # more than a quarter TTL. The FIRST beat is always journaled —
            # it flips the member from expiry-exempt to expirable, and a
            # recovered driver must not grant infinite grace to a lease that
            # had already started beating
            if first_beat or now - m.get("journaled_at", 0.0) >= self.ttl / 4.0:
                m["journaled_at"] = now
                self._journal_locked(
                    {"op": "renew", "eid": executor_id, "beat": m["beat"], "t": now}
                )
        if renewed:
            self._publish_gauges()
        return renewed

    def leave(self, executor_id, reason="done"):
        """Release a lease cleanly (final child_status observed)."""
        changed = False
        with self._lock:
            m = self._members.get(executor_id)
            if m is not None and m["state"] != "left":
                m["state"] = "left"
                changed = True
                self._journal_locked(
                    {"op": "leave", "eid": executor_id, "reason": str(reason)}
                )
        if changed:
            self._publish_gauges()

    def expire_stale(self):
        """Expire every live lease whose last renewal is older than the TTL.
        Returns ``[(executor_id, age_seconds), ...]`` for the newly expired.

        Members that never produced a beat are exempt: their child may still
        be importing its interpreter, and flagging slow startup is the
        launch timeout's job (historical watchdog parity)."""
        expired = []
        with self._lock:
            now = self._clock()
            for eid, m in self._members.items():
                if m["state"] != "live" or m["beat"] is None:
                    continue
                age = now - m["renewed_at"]
                if age > self.ttl:
                    m["state"] = "expired"
                    expired.append((eid, age))
            for eid, age in expired:
                try:
                    self._journal_locked(
                        {"op": "expire", "eid": eid, "t": now, "age": age}
                    )
                except StaleEpochError:
                    raise
                except Exception as e:
                    # journal durability failed (disk full, unwritable dir):
                    # the in-memory expiry stands and is still RETURNED —
                    # failure detection must not depend on the disk. A later
                    # recovery re-derives the expiry from the lease age.
                    logger.warning(
                        "registry: could not journal expiry of %s: %s", eid, e
                    )
                    break
        if expired:
            obs.counter(
                "registry_lease_expirations_total",
                help="membership leases expired without a heartbeat renewal",
            ).inc(len(expired))
            self._publish_gauges()
        return expired

    def blacklist(self, executor_id, reason=""):
        with self._lock:
            if executor_id in self._blacklist:
                return
            self._blacklist[executor_id] = str(reason)
            self._journal_locked(
                {"op": "blacklist", "eid": executor_id, "reason": str(reason)}
            )

    def forgive(self, executor_id):
        """Remove an executor from the blacklist (the regrow path)."""
        with self._lock:
            if executor_id not in self._blacklist:
                return
            self._blacklist.pop(executor_id)
            self._journal_locked({"op": "forgive", "eid": executor_id})

    def crash(self):
        """Simulate the driver dying mid-flight (``control.driver_crash``):
        drop the in-memory state with NO parting commit — a crash does not
        say goodbye — and fence this instance against further writes."""
        with self._lock:
            self._fenced = True
            self._members = {}

    # -- journal / manifest machinery ---------------------------------------

    def _journal_locked(self, record):
        """Append one transition to the journal (caller holds the lock) and
        compact into a manifest every ``manifest_every`` records. In-memory
        state was already mutated by the caller; with no journal_dir this
        degrades to bookkeeping only."""
        self._seq += 1
        record["seq"] = self._seq
        if self.journal_dir is None:
            return
        self._check_fence_locked()
        payload = json.dumps(record, sort_keys=True)
        if chaos.active:
            spec = chaos.fire("control.journal_tear")
            if spec is not None and spec.get("target") == "journal":
                # simulated crash mid-append: half a line, no newline, and
                # this writer stops journaling (it "died")
                with open(os.path.join(self.journal_dir, JOURNAL_NAME), "a") as f:
                    f.write(self._frame(payload)[: max(1, len(payload) // 2)])
                self._fenced = True
                return
            if spec is not None:
                # tear the *manifest* publish instead: force a compaction
                # that dies mid-rename (see _commit_manifest_locked)
                self._commit_manifest_locked(tear=True)
                return
        jpath = os.path.join(self.journal_dir, JOURNAL_NAME)
        creating = not os.path.exists(jpath)
        with open(jpath, "a") as f:
            f.write(self._frame(payload))
            if record["op"] in _DURABLE_OPS:
                f.flush()
                os.fsync(f.fileno())
                obs.counter(
                    "registry_journal_commits_total",
                    help="durable membership journal/manifest commits",
                ).inc()
        if creating:
            # the first append materializes journal.log itself; without a
            # directory fsync a power cut can lose the file while the writer
            # believed its fsynced records were safe
            durable.fsync_dir(self.journal_dir)
        self._records_since_manifest += 1
        if self._records_since_manifest >= self._manifest_every or record["op"] == "epoch":
            self._commit_manifest_locked()

    @staticmethod
    def _frame(payload):
        """One journal line: crc32-of-payload, space, payload, newline."""
        return "{:08x} {}\n".format(zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF, payload)

    def _state_locked(self):
        return {
            "epoch": self._epoch,
            "seq": self._seq,
            "ttl": self.ttl,
            "target_size": self._target_size,
            "members": {str(e): dict(m) for e, m in self._members.items()},
            "roles": {str(e): list(r) for e, r in self._roles.items()},
            "blacklist": {str(e): r for e, r in self._blacklist.items()},
        }

    def _commit_manifest_locked(self, tear=False):
        """Compact state into ``REGISTRY.json`` with the ckpt manifest
        discipline: previous manifest retained as ``.prev``, new manifest
        written tmp+fsync+rename, journal truncated only AFTER the rename
        lands. ``tear=True`` (chaos) aborts mid-publish: a half-written
        manifest over the final name, journal untouched — recovery must
        detect the CRC mismatch and fall back to prev + journal."""
        self._check_fence_locked()
        state = self._state_locked()
        body = json.dumps(state, sort_keys=True)
        payload = {
            "version": VERSION,
            "crc32": zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF,
            "state": state,
        }
        mpath = os.path.join(self.journal_dir, MANIFEST_NAME)
        if os.path.exists(mpath):
            os.replace(mpath, os.path.join(self.journal_dir, PREV_MANIFEST_NAME))
        text = json.dumps(payload, sort_keys=True)
        if tear:
            with open(mpath, "w") as f:
                f.write(text[: len(text) // 2])
            logger.warning("chaos: control.journal_tear — manifest left torn on disk")
            return
        tmp = mpath + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, mpath)
        # make the rename itself durable before the truncation below can be:
        # otherwise a power loss may persist an empty journal next to the
        # OLD manifest, silently losing the folded-in transitions
        durable.fsync_dir(self.journal_dir)
        try:
            self._manifest_stat = self._stat_manifest()
        except OSError:
            self._manifest_stat = None
        # the manifest now owns everything up to seq: restart the journal
        with open(os.path.join(self.journal_dir, JOURNAL_NAME), "w"):
            pass
        self._records_since_manifest = 0
        obs.counter(
            "registry_journal_commits_total",
            help="durable membership journal/manifest commits",
        ).inc()

    def _stat_manifest(self):
        st = os.stat(os.path.join(self.journal_dir, MANIFEST_NAME))
        return (st.st_mtime_ns, st.st_size)

    def _check_fence_locked(self):
        """Refuse durable writes once a newer driver generation owns the
        journal. Cheap: one stat per append, a manifest read only when the
        file actually changed under us."""
        if self._fenced:
            raise StaleEpochError(
                "registry writer fenced: epoch {} is no longer current".format(self._epoch)
            )
        try:
            st = self._stat_manifest()
        except OSError:
            return  # no manifest yet: nothing to be stale against
        if st == self._manifest_stat:
            return
        self._manifest_stat = st
        payload, _reason = _read_manifest_file(
            os.path.join(self.journal_dir, MANIFEST_NAME)
        )
        if payload is not None and payload["state"].get("epoch", 0) > self._epoch:
            self._fenced = True
            raise StaleEpochError(
                "registry journal taken over by epoch {} (this writer is epoch {})".format(
                    payload["state"]["epoch"], self._epoch
                )
            )

    # -- recovery ------------------------------------------------------------

    @classmethod
    def recover(cls, journal_dir, ttl=None, clock=time.time, fallback_epoch=0,
                manifest_every=None):
        """Reconstruct the registry after a driver restart.

        Reads the committed manifest (falling back to the previous one when
        the newest is torn — CRC mismatch), replays journal records with
        ``seq`` beyond the manifest, then re-adopts every member whose lease
        is still inside its TTL on the wall clock: those executors keep
        training through the outage. Members past their TTL come back in
        ``expired`` state and surface through the watchdog as
        ``lease_expired``. The recovered registry resumes at
        ``max(journaled epoch, fallback_epoch) + 1`` and immediately commits
        a manifest at that epoch — the fencing record that stops any
        still-running pre-crash writer.
        """
        reg = cls(ttl=ttl, journal_dir=journal_dir, clock=clock,
                  manifest_every=manifest_every)
        state = _load_state(journal_dir) if journal_dir else None
        readopted, expired_on_recover = [], []
        with reg._lock:
            if state is not None:
                reg._seq = int(state.get("seq", 0))
                reg._roles = {int(e): list(r) for e, r in (state.get("roles") or {}).items()}
                reg._blacklist = {int(e): r for e, r in (state.get("blacklist") or {}).items()}
                now = reg._clock()
                for eid_s, m in (state.get("members") or {}).items():
                    eid = int(eid_s)
                    m = dict(m)
                    if m.get("state") == "live":
                        age = now - m.get("renewed_at", 0.0)
                        if m.get("beat") is not None and age > reg.ttl:
                            m["state"] = "expired"
                            expired_on_recover.append(eid)
                        else:
                            readopted.append(eid)
                    reg._members[eid] = m
                reg._epoch = max(int(state.get("epoch", 0)), fallback_epoch) + 1
                if state.get("target_size") is not None:
                    reg._target_size = int(state["target_size"])
            else:
                reg._epoch = fallback_epoch + 1
            restart_rec = {
                "op": "epoch", "epoch": reg._epoch, "reason": "driver-restart",
                "roles": {str(e): list(r) for e, r in reg._roles.items()},
            }
            if reg._target_size is not None:
                restart_rec["target"] = reg._target_size
            reg._journal_locked(restart_rec)
            if reg.journal_dir is not None:
                reg._commit_manifest_locked()  # the fencing record
        if expired_on_recover:
            obs.counter(
                "registry_lease_expirations_total",
                help="membership leases expired without a heartbeat renewal",
            ).inc(len(expired_on_recover))
        reg._publish_gauges()
        logger.info(
            "registry recovered: epoch=%d re-adopted=%s expired=%s blacklist=%s",
            reg.epoch, readopted, expired_on_recover, reg.blacklisted(),
        )
        return reg

    # -- metrics -------------------------------------------------------------

    def _publish_gauges(self):
        obs.gauge(
            "registry_leases_active", help="members holding a live lease"
        ).set(self.leases_active())
        obs.gauge(
            "registry_epoch", help="current cluster membership epoch"
        ).set(self.epoch)

    def __repr__(self):
        return "MembershipRegistry(epoch={}, live={}, blacklist={}, journal={})".format(
            self.epoch, self.live_members(), self.blacklisted(), self.journal_dir
        )


def _read_manifest_file(path):
    """(payload, reason): payload is the parsed, CRC-verified manifest dict
    or None; reason explains a None."""
    if not os.path.isfile(path):
        return None, "absent"
    try:
        with open(path) as f:
            payload = json.load(f)
    except (ValueError, OSError) as e:
        return None, "torn manifest ({})".format(e)
    state = payload.get("state")
    if not isinstance(state, dict):
        return None, "torn manifest (no state)"
    body = json.dumps(state, sort_keys=True)
    if zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF != payload.get("crc32"):
        return None, "checksum mismatch"
    return payload, "verified"


def _load_state(journal_dir):
    """Committed state + journal replay; None when nothing recoverable.

    The newest manifest is CRC-verified; a torn one falls back to the
    retained previous manifest (journal records since then are still on
    disk — truncation only follows a *successful* publish). Journal lines
    are CRC-framed; replay stops at the first torn/corrupt line (everything
    after a tear is from a writer that should have been dead)."""
    journal_dir = os.path.abspath(os.path.expanduser(journal_dir))
    state = None
    for name in (MANIFEST_NAME, PREV_MANIFEST_NAME):
        payload, reason = _read_manifest_file(os.path.join(journal_dir, name))
        if payload is not None:
            state = payload["state"]
            if name == PREV_MANIFEST_NAME:
                logger.warning(
                    "registry: newest manifest unusable; recovered from %s", name
                )
            break
        if name == MANIFEST_NAME and reason != "absent":
            logger.warning("registry: %s %s; trying previous manifest", MANIFEST_NAME, reason)
    if state is None:
        state = {"epoch": 0, "seq": 0, "members": {}, "roles": {}, "blacklist": {}}
    jpath = os.path.join(journal_dir, JOURNAL_NAME)
    if not os.path.isfile(jpath):
        return state
    applied = 0
    with open(jpath, "r", errors="replace") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            crc_hex, _, payload = line.partition(" ")
            try:
                ok = int(crc_hex, 16) == zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF
            except ValueError:
                ok = False
            if not ok:
                logger.warning("registry: torn journal line after %d replayed; stopping", applied)
                break
            try:
                record = json.loads(payload)
            except ValueError:
                logger.warning("registry: corrupt journal record after %d replayed; stopping", applied)
                break
            if record.get("seq", 0) <= state.get("seq", 0):
                continue  # already folded into the manifest
            _apply_record(state, record)
            state["seq"] = record["seq"]
            applied += 1
    if applied:
        logger.info("registry: replayed %d journal record(s) past the manifest", applied)
    return state


def _apply_record(state, record):
    """Fold one journal record into a manifest-shaped state dict."""
    op = record.get("op")
    members = state.setdefault("members", {})
    eid = str(record.get("eid"))
    if op == "epoch":
        state["epoch"] = record.get("epoch", state.get("epoch", 0))
        if record.get("roles"):
            state["roles"] = dict(record["roles"])
        if record.get("target") is not None:
            state["target_size"] = record["target"]
        state["members"] = {}
    elif op == "role":
        state.setdefault("roles", {})[eid] = [record.get("job"), record.get("task", 0)]
    elif op == "join":
        t = record.get("t", 0.0)
        m = members.get(eid) or {"joined_at": t, "beat": None}
        m.update({
            "job": record.get("job"), "task": record.get("task"),
            "renewed_at": t, "journaled_at": t, "state": "live",
        })
        members[eid] = m
        if record.get("job") is not None:
            state.setdefault("roles", {})[eid] = [record["job"], record.get("task") or 0]
    elif op == "renew":
        m = members.get(eid)
        if m is not None:
            m["renewed_at"] = record.get("t", m.get("renewed_at", 0.0))
            m["journaled_at"] = m["renewed_at"]
            m["beat"] = record.get("beat")
            if m.get("state") == "expired":
                m["state"] = "live"
    elif op == "expire":
        m = members.get(eid)
        if m is not None:
            m["state"] = "expired"
    elif op == "leave":
        m = members.get(eid)
        if m is not None:
            m["state"] = "left"
    elif op == "blacklist":
        state.setdefault("blacklist", {})[eid] = record.get("reason", "")
    elif op == "forgive":
        state.setdefault("blacklist", {}).pop(eid, None)
    # unknown ops from a newer writer are skipped: forward-compatible replay


# ---------------------------------------------------------------------------
# executor-side heartbeat aggregation
# ---------------------------------------------------------------------------


class HeartbeatAggregator:
    """Daemon thread run by an elected aggregator executor: polls its group
    members' channels every window and publishes one summary on its OWN
    channel under :data:`WINDOW_KEY`::

        {"window": n, "ts": wall, "beats": {"<eid>": beat},
         "status": {"<eid>": child_status}, "errors": [eid, ...]}

    ``errors`` flags members with a non-empty error queue — the driver then
    fetches the traceback from exactly those nodes, keeping the steady-state
    fan-in at the aggregator count. Dies quietly when its own channel goes
    away (the executor is being torn down), mirroring the heartbeat thread.
    """

    def __init__(self, mgr, member_rows, authkey, window_secs=None, obs_enabled=True):
        self._mgr = mgr
        self._rows = [dict(r) for r in member_rows]
        self._authkey = authkey
        self._window = WINDOW_SECS if window_secs is None else float(window_secs)
        self._obs_enabled = bool(obs_enabled)
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        self._thread = threading.Thread(
            target=self._run, name="tos-heartbeat-agg", daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            # bounded: the poll loop re-checks the stop event every window
            self._thread.join(timeout=self._window + 5.0)
            self._thread = None

    def _run(self):
        from tensorflowonspark_tpu_torch import TFManager

        # private registry: the executor process outlives the cluster run,
        # and this lane must not double-count the process-global registry
        reg = obs_registry.Registry(enabled=self._obs_enabled)
        windows = reg.counter(
            "heartbeat_agg_windows_total",
            help="per-window heartbeat summaries published by aggregators",
        )
        channels = {}
        own_failures = 0
        ticker = resilience.Ticker(self._window, jitter=0.2, seed=os.getpid())
        for n in ticker.ticks():
            if self._stop.is_set():
                return
            beats, status, errors = {}, {}, []
            for row in self._rows:
                eid = row["executor_id"]
                try:
                    mgr = channels.get(eid)
                    if mgr is None:
                        mgr = channels[eid] = TFManager.connect(
                            tuple(row["manager_addr"]), self._authkey
                        )
                    st = mgr.get("child_status")
                    if st is not None:
                        status[str(eid)] = st
                    beat = mgr.get("heartbeat")
                    if beat is not None:
                        beats[str(eid)] = beat
                    if not mgr.get_queue("error").empty():
                        errors.append(eid)
                except Exception:
                    channels.pop(eid, None)  # reconnect next window
            summary = json.dumps(
                {"window": n, "ts": time.time(), "beats": beats,
                 "status": status, "errors": errors}
            )
            if self._stop.is_set():
                return  # stopped mid-gather: a replacement owns WINDOW_KEY now
            try:
                self._mgr.set(WINDOW_KEY, summary)
                windows.inc()
                obs_aggregate.publish_to_channel(self._mgr, reg, key=AGGREGATOR_KEY)
                if self._mgr.get("state") == "stopped":
                    return  # node retired: stop summarizing
                own_failures = 0
            except Exception:
                own_failures += 1
                if own_failures >= 5:
                    return  # own channel stayed dead: executor going away
