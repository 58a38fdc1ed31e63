"""Recovery supervisor: failure classification, blacklisting, shrink-to-fit.

:func:`TFCluster.run_with_recovery` closes the detect → abort → relaunch loop,
but a bare retry counter relaunches at **full size** every time: if an executor
is permanently gone (TPU host preempted, bad device, full disk), every attempt
re-reserves the same dead capacity and burns the whole budget failing
identically. This module upgrades that loop into a **recovery ladder**:

1. **Classify** — every failed attempt becomes a :class:`FailureEvent` with a
   kind (``launch`` / ``reservation_timeout`` / ``lease_expired`` /
   ``heartbeat_loss`` / ``node_exit`` / ``node_error`` / ``feed_timeout`` /
   ``preemption`` / ``unknown``) and, where the failure text or exception
   chain allows, the
   executor ids it implicates (:func:`classify_failure`). The :class:`FailureLedger` keeps these in a
   sliding window and enforces the restart budget against the *window*, not
   all time — a cluster that fails once a week is healthy; one that fails
   three times in an hour is not.
2. **Gate** — before a relaunch, a short Spark task per candidate executor
   probes scratch-dir writability, TCP loopback, accelerator visibility and
   (when one survives) the manager channel (``TFSparkNode.preflight``).
   Executors failing the probe — and executors the ledger attributes repeated
   losses to — land on a **blacklist** threaded through
   :func:`TFCluster.build_cluster_template` (roles skip them) and
   :class:`reservation.Server` (late registrations from them are refused).
3. **Shrink to fit** — the next attempt runs at ``num_executors − len(blacklist)``
   (never below ``min_workers`` training participants — the ladder raises
   instead). ``map_fun`` restores the latest checkpoint at the smaller size
   (under replicated data parallelism a plain restore; onto another mesh,
   :func:`tensorflowonspark_tpu_torch.ckpt.reshard_restore`), so training
   *continues* instead
   of dying. With ``regrow=True``
   blacklisted executors are re-probed at every relaunch — a checkpoint
   boundary by construction — and forgiven when they pass, growing the
   cluster back toward full size.
4. **Regrow mid-run** — shrink-to-fit alone ratchets downward: once the
   cluster is small, nothing restores it until the *next* failure. With
   ``regrow_check_secs > 0`` the ladder also re-probes the condemned
   executors *while the shrunk attempt trains*; when enough come back
   healthy that the :class:`~tensorflowonspark_tpu_torch.control.ClusterScaler`
   (patience-gated, stall-classified — never steal capacity from an
   input-bound run) votes to grow, the driver posts a **preemption
   warning** (:meth:`TFCluster.TFCluster.preempt`). Workers drain their
   async checkpoints, commit a ``preempted`` parting status into the
   membership registry and exit clean — a deliberate restart at a
   checkpoint boundary — and the ladder's normal classify → forgive →
   relaunch machinery resumes onto the larger mesh. A ``preemption``
   failure is *warned* downsizing, not pathology: it never blacklists and
   never consumes the restart budget (:data:`BUDGET_EXEMPT_KINDS`). The
   same classification covers platform preemption notices (the jax child's
   SIGTERM handler runs the identical drain), so a preempted-then-returning
   executor rejoins without a ledger entry. The planned size is journaled
   per generation (``MembershipRegistry.begin_generation(target_size=…)``)
   so the ladder's position on the shrink/regrow ladder survives a driver
   restart.

Driver-side metrics (all visible in ``TFCluster.metrics()``):
``recovery_attempts_total``, ``recovery_shrinks_total``,
``recovery_regrows_total``, ``preemptions_drained_total``,
``recovery_seconds_total`` (wall time spent between failure detection and
relaunch decision), and the ``executors_blacklisted`` gauge.
"""

import logging
import re
import time

from tensorflowonspark_tpu_torch import TFCluster, TFSparkNode, control, obs, reservation
from tensorflowonspark_tpu_torch import registry as membership
from tensorflowonspark_tpu_torch.obs import flight as obs_flight
from tensorflowonspark_tpu_torch.obs import tracing as obs_tracing

logger = logging.getLogger(__name__)

#: failure kinds that implicate a *node* (vs. the control plane or the feed):
#: only these count toward an executor's blacklist score
LOSS_KINDS = frozenset(
    {"heartbeat_loss", "lease_expired", "node_exit", "reservation_timeout"}
)

#: failure kinds that never consume the restart budget: a *warned* loss — the
#: node drained its checkpoints and committed a parting status before exiting
#: — is planned downsizing (platform preemption notice, or the ladder's own
#: regrow restart), not pathology. Only unwarned failures should be able to
#: exhaust ``max_restarts``.
BUDGET_EXEMPT_KINDS = frozenset({"preemption"})

_NODE_RE = re.compile(r"node (\w+):(\d+)")
_EXIT_RE = re.compile(r"failed \(exit (-?\d+)\)")
#: the registry watchdog stamps the executor id directly into the message —
#: attribution without a role_map round-trip
_EXEC_RE = re.compile(r"\(executor (\d+)\)")


class FailureEvent:
    """One classified attempt failure.

    ``kind`` is the failure signature; ``executor_ids`` the executors the
    evidence implicates (may be empty — not every failure is attributable);
    ``message`` the original failure text.
    """

    def __init__(self, kind, executor_ids=(), message=""):
        self.kind = kind
        self.executor_ids = sorted(set(executor_ids))
        self.message = str(message)

    def __repr__(self):
        return "FailureEvent(kind={!r}, executor_ids={})".format(
            self.kind, self.executor_ids
        )


def classify_failure(exc, role_map=None):
    """Classify an attempt failure into a :class:`FailureEvent`.

    Walks the exception chain (``__cause__``/``__context__``) because the
    interesting evidence is often wrapped: a ``reservation.ReservationError``
    carrying ``missing`` executor ids inside a launch ``RuntimeError``, or a
    backend ``TaskError`` carrying ``executor_id`` under the task-failure
    wrapper. ``role_map`` maps ``"job:task_index"`` to executor id so
    watchdog messages ("node worker:1 stopped heartbeating") attribute too.
    """
    role_map = role_map or {}
    chain, seen = [], set()
    e = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        chain.append(e)
        e = e.__cause__ or e.__context__
    text = "\n".join(str(c) for c in chain)

    executor_ids = set()
    missing = []
    for c in chain:
        m = getattr(c, "missing", None)  # reservation.ReservationError
        if m:
            missing = list(m)
        eid = getattr(c, "executor_id", None)  # backends TaskError
        if eid is not None:
            executor_ids.add(eid)
    for job, task in _NODE_RE.findall(text):
        key = "{}:{}".format(job, task)
        if key in role_map:
            executor_ids.add(role_map[key])
    for eid in _EXEC_RE.findall(text):
        executor_ids.add(int(eid))

    if missing or any(isinstance(c, reservation.ReservationError) for c in chain):
        return FailureEvent("reservation_timeout", executor_ids | set(missing), text)
    if "preempted" in text:
        # the child's preemption drain commits a ``preempted`` parting status
        # before exiting, and the watchdog stamps it into the failure text;
        # checked before the lease/heartbeat phrasings because a drained
        # child's exit can surface alongside a late expiry message — the
        # warned signal wins
        return FailureEvent("preemption", executor_ids, text)
    if "lease expired" in text:
        # the registry watchdog's first-class expiry event; checked before
        # the legacy phrasing because its messages contain both
        return FailureEvent("lease_expired", executor_ids, text)
    if "stopped heartbeating" in text:
        return FailureEvent("heartbeat_loss", executor_ids, text)
    if "feed timeout" in text:
        return FailureEvent("feed_timeout", executor_ids, text)
    exit_match = _EXIT_RE.search(text)
    if exit_match:
        # negative exit = killed by signal (SIGKILL/OOM) = the node went away;
        # a positive exit is the user fn failing, which no blacklist fixes
        kind = "node_exit" if int(exit_match.group(1)) < 0 else "node_error"
        return FailureEvent(kind, executor_ids, text)
    if "failed:" in text:  # error-queue traceback via the watchdog/shutdown
        return FailureEvent("node_error", executor_ids, text)
    if executor_ids:  # a TaskError with no recognizable inner signature
        return FailureEvent("launch", executor_ids, text)
    return FailureEvent("unknown", executor_ids, text)


class FailureLedger:
    """Sliding-window record of attempt failures driving the ladder.

    * ``allow_restart()`` — True while the failures inside ``window_secs``
      stay within ``max_restarts`` (the old all-time counter is the special
      case ``window_secs=inf``). *Warned* failures
      (:data:`BUDGET_EXEMPT_KINDS`) are recorded — they still show up in
      ``events()`` and the trace — but never consume the budget.
    * ``suspects()`` — executor ids implicated in at least
      ``blacklist_after`` *loss-kind* failures (:data:`LOSS_KINDS`) inside
      the window. One transient fault never blacklists a node; repeated
      attributed losses do.
    * ``clear(eid)`` — forgive an executor (regrow passed its preflight).

    ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, max_restarts=2, window_secs=3600.0, blacklist_after=2,
                 clock=time.monotonic):
        self.max_restarts = max_restarts
        self.window_secs = float(window_secs)
        self.blacklist_after = blacklist_after
        self._clock = clock
        self._events = []  # (t, FailureEvent), pruned lazily

    def record(self, event):
        self._events.append((self._clock(), event))
        return event

    def _recent(self):
        cutoff = self._clock() - self.window_secs
        self._events = [(t, e) for t, e in self._events if t >= cutoff]
        return self._events

    def failures_in_window(self):
        """Budget-relevant failures inside the window: warned kinds
        (:data:`BUDGET_EXEMPT_KINDS`) drained cleanly and do not count."""
        return sum(
            1 for _, e in self._recent() if e.kind not in BUDGET_EXEMPT_KINDS
        )

    def allow_restart(self):
        return self.failures_in_window() <= self.max_restarts

    def suspects(self):
        """Executor ids with >= ``blacklist_after`` loss-kind failures in
        the window, sorted."""
        counts = {}
        for _, event in self._recent():
            if event.kind not in LOSS_KINDS:
                continue
            for eid in event.executor_ids:
                counts[eid] = counts.get(eid, 0) + 1
        return sorted(e for e, n in counts.items() if n >= self.blacklist_after)

    def clear(self, executor_id):
        """Drop every event implicating ``executor_id`` (and only it) —
        the regrow path's forgiveness after a clean re-probe."""
        self._events = [
            (t, e) for t, e in self._events
            if e.executor_ids != [executor_id]
        ]

    def events(self):
        """The (time, event) pairs currently inside the window."""
        return list(self._recent())


def plan_size(num_executors, blacklist, min_workers=1, overhead=0):
    """Next attempt's executor count: full size minus the blacklist.

    ``overhead`` is the non-training role count (ps/evaluator) so
    ``min_workers`` bounds actual *training participants*. Raises
    ``RuntimeError`` rather than clamping when the surviving capacity cannot
    hold ``min_workers`` — silently training on less capacity than the user's
    floor is worse than failing loudly.
    """
    target = num_executors - len(blacklist)
    if target - overhead < min_workers:
        raise RuntimeError(
            "cannot shrink below min_workers={}: {} executor(s) minus {} "
            "blacklisted leaves {} worker(s)".format(
                min_workers, num_executors, len(blacklist), target - overhead
            )
        )
    return target


def preflight_executors(sc, executor_ids, extra_probe=None):
    """Run the per-executor health gate; returns ``{executor_id: reason}``
    for the executors that failed it.

    Each executor is probed with its own single-partition pinned task so one
    dead executor cannot mask the others' reports (a shared job would abort
    on the first task failure). Requires a backend with executor pinning
    (``sc.PIN_SUPPORTED``) — without it a probe's report cannot be attributed
    to a specific executor, so the gate reports nothing.
    """
    if not getattr(sc, "PIN_SUPPORTED", False):
        logger.info("preflight: backend cannot pin tasks to executors; skipping")
        return {}
    bad = {}
    task = TFSparkNode.preflight(extra_probe=extra_probe)
    for eid in executor_ids:
        try:
            reports = (
                sc.parallelize([eid], 1, pin_to_executors=[eid])
                .mapPartitions(task)
                .collect()
            )
        except Exception as e:
            bad[eid] = "probe task failed: {}".format(e)
            continue
        report = next((r for r in reports if r.get("executor_id") == eid), None)
        if report is None:
            bad[eid] = "no probe report returned"
        elif not report.get("ok"):
            failing = {
                k: v for k, v in (report.get("checks") or {}).items() if v != "ok"
            }
            bad[eid] = "; ".join(
                "{}={}".format(k, v) for k, v in sorted(failing.items())
            )
    if bad:
        logger.warning("preflight failed for executors %s", sorted(bad))
    return bad


def _counter_value(snapshot, name):
    return ((snapshot.get("counters") or {}).get(name) or {}).get("value", 0.0)


def _regrow_poll(sc, cluster, scaler, blacklist, num_executors, target, extra_probe):
    """One checkpoint-boundary regrow check while a shrunk attempt trains.

    Re-probes the condemned executors; when enough come back healthy that
    the scaler votes to grow — patience-gated, and deferred while the
    cluster-wide stall classification says the run is input-bound (more
    devices would only starve harder) — posts a preemption warning to the
    running workers. They drain their async checkpoints, commit a
    ``preempted`` parting status and exit clean, and the ladder's normal
    classify → forgive → relaunch machinery resumes training on the larger
    mesh. Returns True when a regrow restart was requested.
    """
    healthy = sorted(
        set(blacklist) - set(preflight_executors(sc, sorted(blacklist), extra_probe))
    )
    desired = num_executors - (len(blacklist) - len(healthy))
    try:
        # the trainers' input path: the driver's own registry may hold the
        # stall counters of pipelines it ran itself, which say nothing of
        # whether more trainers would starve
        snapshot = cluster.metrics(include_driver=False) or {}
    except Exception:
        snapshot = {}
    classification = control.classify_stalls(
        _counter_value(snapshot, "data_producer_read_seconds_total"),
        _counter_value(snapshot, "data_producer_parse_seconds_total"),
        _counter_value(snapshot, "data_producer_emit_seconds_total"),
        _counter_value(snapshot, "data_consumer_wait_seconds_total"),
    )
    allowed = scaler.decide(target, desired, classification)
    if allowed <= target:
        return False
    with obs.span(
        "elastic_regrow", current=target, target=allowed,
        healthy=healthy, classification=classification,
    ):
        reached = cluster.preempt(
            "regrow to {} executor(s): {} recovered".format(allowed, healthy)
        )
        logger.info(
            "regrow: preemption warning posted to executors %s (%d -> %d)",
            reached, target, allowed,
        )
    return True


class ElasticResult:
    """Outcome of a completed :func:`run_ladder` run.

    ``metrics`` is the cluster metrics snapshot captured just before the
    final (successful) shutdown — the only moment both the node counters and
    the driver's recovery counters are simultaneously readable.
    """

    def __init__(self, relaunches, num_executors, blacklist, metrics, events):
        self.relaunches = relaunches
        self.num_executors = num_executors
        self.blacklist = frozenset(blacklist)
        self.metrics = metrics
        self.events = list(events)

    def __repr__(self):
        return "ElasticResult(relaunches={}, num_executors={}, blacklist={})".format(
            self.relaunches, self.num_executors, sorted(self.blacklist)
        )


def run_ladder(
    sc,
    map_fun,
    tf_args,
    num_executors,
    max_relaunches=2,
    min_workers=1,
    blacklist_after=2,
    window_secs=3600.0,
    preflight=True,
    regrow=False,
    regrow_check_secs=0.0,
    scaler=None,
    extra_probe=None,
    poll_secs=1.0,
    shutdown_timeout=600,
    completion_timeout=None,
    feed_fn=None,
    ledger=None,
    **run_kwargs,
):
    """The recovery ladder: run → classify the failure → blacklist → shrink →
    relaunch, until the run completes or the ledger's window budget is spent.

    The attempt/teardown semantics match the historical
    ``run_with_recovery`` loop exactly (TENSORFLOW mode waits for worker
    completion; SPARK mode drives ``feed_fn``; every failed attempt is
    ``abort()``-ed *before* deciding whether to relaunch, so on the final
    failure the caller still gets their executors back, and the raised
    ``RuntimeError`` chains the last underlying failure). What the ladder
    adds on top:

    * ``blacklist_after`` loss-kind failures attributed to one executor
      (see :data:`LOSS_KINDS`) blacklist it; a single transient fault still
      relaunches at full size, preserving the pre-ladder behaviour.
    * candidates for the next attempt are preflight-probed
      (:func:`preflight_executors`); probe failures extend the blacklist
      before the relaunch instead of burning an attempt discovering them.
    * the relaunch runs at ``num_executors − len(blacklist)`` — shrink to
      fit — and raises rather than go below ``min_workers`` training
      participants. ``map_fun`` must restore via
      :func:`tensorflowonspark_tpu_torch.ckpt.reshard_restore`
      (or ``restore_latest`` when sizes match) to continue the trajectory
      on the smaller mesh.
    * ``regrow=True`` re-probes blacklisted executors at every relaunch
      (a checkpoint boundary by construction); executors that pass are
      forgiven (``ledger.clear``) and rejoin the next attempt.
    * ``regrow_check_secs > 0`` (TENSORFLOW mode, with ``regrow``) also
      re-probes *while a shrunk attempt trains*: every interval the ladder
      probes the condemned executors and asks the ``scaler`` (default: a
      :class:`~tensorflowonspark_tpu_torch.control.ClusterScaler` spanning
      ``min_workers + overhead … num_executors``) whether to grow. A grow
      verdict posts a preemption warning — workers drain checkpoints,
      commit a ``preempted`` parting status and exit clean — and the next
      attempt resumes onto the larger mesh via
      :func:`tensorflowonspark_tpu_torch.ckpt.reshard_restore`.
      ``preemption`` failures (this path, and real platform SIGTERMs) never
      blacklist and never consume the restart budget.

    ``ledger`` is injectable for tests; by default a fresh
    :class:`FailureLedger` with this call's budget/window. Returns an
    :class:`ElasticResult`.
    """
    mode = run_kwargs.get("input_mode", TFCluster.InputMode.SPARK)
    if mode != TFCluster.InputMode.TENSORFLOW and feed_fn is None:
        raise ValueError(
            "run_ladder in SPARK mode needs feed_fn=<your feed loop>; "
            "without a feed, use input_mode=InputMode.TENSORFLOW"
        )
    if mode == TFCluster.InputMode.TENSORFLOW and feed_fn is not None:
        raise ValueError("feed_fn requires input_mode=InputMode.SPARK")
    if ledger is None:
        ledger = FailureLedger(
            max_restarts=max_relaunches,
            window_secs=window_secs,
            blacklist_after=blacklist_after,
        )
    overhead = run_kwargs.get("num_ps", 0) + (1 if run_kwargs.get("eval_node") else 0)
    # ONE membership registry across every attempt: each relaunch is a new
    # generation under a higher epoch, and the blacklist is journaled so a
    # restarted driver inherits the ladder's condemnations, not just the
    # current attempt's roster
    registry = run_kwargs.pop("registry", None)
    if registry is None:
        registry = membership.MembershipRegistry(
            journal_dir=run_kwargs.pop("registry_dir", None)
        )
    else:
        run_kwargs.pop("registry_dir", None)
    if regrow and regrow_check_secs > 0 and scaler is None:
        scaler = control.ClusterScaler(
            num_executors, min_size=min_workers + overhead
        )
    blacklist = set()
    target = num_executors
    relaunches = 0

    while True:
        template = TFCluster.build_cluster_template(
            target,
            run_kwargs.get("num_ps", 0),
            run_kwargs.get("master_node", "chief"),
            run_kwargs.get("eval_node", False),
            blacklist=blacklist,
        )
        role_map = {
            "{}:{}".format(job, idx): eid for eid, (job, idx) in template.items()
        }
        failure = None
        cluster = None
        try:
            cluster = TFCluster.run(
                sc, map_fun, tf_args, target,
                blacklist=sorted(blacklist) or None, registry=registry,
                **run_kwargs
            )
        except Exception as e:
            failure = e
        if cluster is not None:
            snapshot = None
            try:
                if feed_fn is not None:
                    # SPARK mode: drive the caller's feed; a dead node
                    # surfaces as a feed-task exception (queue timeout) or
                    # as a watchdog error raced past the feed's return
                    feed_fn(cluster)
                    cluster.check_errors()
                else:
                    # wait for training to finish, cutting out early on a
                    # detected node failure (watchdog error-queue peek /
                    # heartbeat loss); NOT a launch-thread join — ps/
                    # evaluator tasks park until shutdown, so the launch
                    # job outlives training by design
                    if scaler is not None and regrow_check_secs > 0 and blacklist:
                        # slice the wait so the ladder can re-probe condemned
                        # executors and regrow mid-run (a requested regrow
                        # surfaces as a ``preempted`` failure below)
                        deadline = (
                            time.monotonic() + completion_timeout
                            if completion_timeout else None
                        )
                        while True:
                            slice_secs = regrow_check_secs
                            if deadline is not None:
                                slice_secs = min(
                                    slice_secs,
                                    max(deadline - time.monotonic(), 0.0),
                                )
                            if cluster.wait_for_completion(
                                poll_secs, timeout=slice_secs
                            ):
                                break
                            if deadline is not None and time.monotonic() >= deadline:
                                break
                            if _regrow_poll(
                                sc, cluster, scaler, blacklist,
                                num_executors, target, extra_probe,
                            ):
                                # drain requested: wait for the parting
                                # statuses to land, then let classification
                                # run the relaunch
                                remaining = (
                                    max(deadline - time.monotonic(), 0.0)
                                    if deadline is not None else None
                                )
                                cluster.wait_for_completion(
                                    poll_secs, timeout=remaining
                                )
                                break
                    else:
                        cluster.wait_for_completion(
                            poll_secs, timeout=completion_timeout
                        )
                if not cluster.tf_status.get("error"):
                    # snapshot BEFORE shutdown: node channels (and with them
                    # the child-side counters) do not survive teardown
                    try:
                        snapshot = cluster.metrics()
                    except Exception:
                        snapshot = None
                cluster.shutdown(timeout=shutdown_timeout)
                return ElasticResult(
                    relaunches, target, blacklist, snapshot, ledger.events()
                )
            except Exception as e:
                failure = e

        # -- the ladder: classify → budget-check → blacklist → shrink ---------
        t0 = time.monotonic()
        event = ledger.record(classify_failure(failure, role_map=role_map))
        # black-box moment: the classified failure goes onto the trace (same
        # trace_id as the killed child's last spans and the watchdog's
        # lease_expired event — mint() is idempotent across relaunches) and
        # the driver's flight shard is flushed before the recovery decision
        obs_tracing.event(
            "failure_classified", kind=event.kind,
            executor_ids=sorted(event.executor_ids), attempt=relaunches + 1,
        )
        obs_flight.dump("failure_classified:{}".format(event.kind))
        obs.counter(
            "recovery_attempts_total", help="failed cluster attempts entering recovery"
        ).inc()
        if event.kind == "preemption":
            # driver-side by necessity: the drained child's own counters die
            # with its generation's channels
            obs.counter(
                "preemptions_drained_total",
                help="preemption warnings that drained checkpoints before exit",
            ).inc(max(1, len(event.executor_ids)))
        relaunches += 1
        # tear the failed attempt down BEFORE deciding whether to relaunch:
        # on the final failure the caller still gets their executors back
        if cluster is not None:
            cluster.abort("attempt {} failed: {}".format(relaunches, failure))
        if not ledger.allow_restart():
            obs.counter(
                "recovery_seconds_total",
                help="wall seconds spent in recovery (failure to relaunch decision)",
            ).inc(time.monotonic() - t0)
            raise RuntimeError(
                "training failed after {} relaunch(es): {}".format(
                    relaunches - 1, failure
                )
            ) from failure

        # the relaunch decision is itself a span: the merged timeline shows
        # kill -> lease_expired -> failure_classified -> elastic_relaunch in
        # causal order on one trace
        with obs.span("elastic_relaunch", attempt=relaunches, kind=event.kind):
            if regrow and blacklist:
                # a relaunch resumes from the latest checkpoint, so this IS the
                # checkpoint boundary: re-probe condemned executors and forgive
                # the ones that come back healthy
                recovered = sorted(
                    blacklist - set(preflight_executors(sc, sorted(blacklist), extra_probe))
                )
                for eid in recovered:
                    blacklist.discard(eid)
                    ledger.clear(eid)
                    registry.forgive(eid)
                if recovered:
                    logger.info("regrow: executors %s passed re-probe; unblacklisted",
                                recovered)
            blacklist.update(ledger.suspects())
            for eid in sorted(blacklist):
                registry.blacklist(eid, reason=event.kind)

            # shrink to surviving capacity, then preflight the actual candidates;
            # gate failures shrink further (and can trip the min_workers floor)
            while True:
                new_target = plan_size(
                    num_executors, blacklist, min_workers=min_workers, overhead=overhead
                )
                candidates = sorted(
                    TFCluster.build_cluster_template(
                        new_target,
                        run_kwargs.get("num_ps", 0),
                        run_kwargs.get("master_node", "chief"),
                        run_kwargs.get("eval_node", False),
                        blacklist=blacklist,
                    )
                )
                if not preflight:
                    break
                bad = preflight_executors(sc, candidates, extra_probe)
                if not bad:
                    break
                for eid, reason in sorted(bad.items()):
                    logger.warning("blacklisting executor %s: %s", eid, reason)
                    registry.blacklist(eid, reason="preflight: {}".format(reason))
                blacklist.update(bad)
            if new_target < target:
                obs.counter(
                    "recovery_shrinks_total",
                    help="relaunches that shrank the cluster to surviving capacity",
                ).inc()
            elif new_target > target:
                obs.counter(
                    "recovery_regrows_total",
                    help="relaunches that grew the cluster back toward full size",
                ).inc()
            obs.gauge(
                "executors_blacklisted", help="executors currently blacklisted"
            ).set(len(blacklist))
            obs.counter(
                "recovery_seconds_total",
                help="wall seconds spent in recovery (failure to relaunch decision)",
            ).inc(time.monotonic() - t0)
            logger.warning(
                "cluster attempt %d failed (%s: %s); relaunching with %d executor(s)%s",
                relaunches, event.kind, failure, new_target,
                " (blacklist: {})".format(sorted(blacklist)) if blacklist else "",
            )
            target = new_target
            if scaler is not None:
                # the relaunch is the scaler's actuation landing: reset its
                # patience streaks so the next verdict starts fresh
                scaler.observe(new_target)
