"""Driver-side cluster lifecycle API.

Capability-parity with /root/reference/tensorflowonspark/TFCluster.py: validate
the cluster template, start the reservation server, launch one node per
executor through the execution backend, block until the cluster assembles, and
expose ``train`` / ``inference`` / ``shutdown``.

TPU-native differences (SURVEY.md §7):

* the assembled reservations define a **torch.distributed world** (rendezvous
  address + ranks) instead of a TF ClusterSpec/TF_CONFIG;
* ``ps`` nodes are accepted for API compatibility but do no training work —
  sync data parallelism with all-reduced gradients replaces both
  MultiWorkerMirroredStrategy and ParameterServerStrategy;
* works against a real ``pyspark.SparkContext`` or the bundled local
  multi-process backend (:mod:`tensorflowonspark_tpu_torch.backends.local`).
"""

import logging
import os
import random
import secrets
import threading
import time as _time

from tensorflowonspark_tpu_torch import TFSparkNode, TFManager, chaos, reservation, resilience
from tensorflowonspark_tpu_torch import registry as membership
from tensorflowonspark_tpu_torch.obs import aggregate as obs_aggregate
from tensorflowonspark_tpu_torch.obs import flight as obs_flight
from tensorflowonspark_tpu_torch.obs import registry as obs_registry
from tensorflowonspark_tpu_torch.obs import tracing as obs_tracing

logger = logging.getLogger(__name__)


class InputMode:
    """How the training program ingests data (reference TFCluster.py:43-49)."""

    TENSORFLOW = 0  #: user code reads its own data (GCS/HDFS/tfds) — perf path
    SPARK = 1  #: Spark partitions stream through the executor feed queues


def _worker_rows(cluster_info):
    """Training-participant rows with a reachable channel; the single
    definition of "which nodes count as workers" shared by shutdown,
    completion-wait, and abort (ps/evaluator are driver-managed separately)."""
    return [
        r for r in cluster_info or []
        if r["job_name"] in ("chief", "master", "worker") and r.get("manager_addr")
    ]


def _abort_nodes(cluster_info, authkey, reason):
    """Best-effort abort broadcast to every reachable node channel: posts the
    ``"abort"`` reason (the executor-side watcher kills the jax child) and
    releases parked ps/evaluator control loops. Returns
    {executor_id: (row, mgr)} for the nodes that acknowledged the post."""
    reached = {}
    for row in cluster_info or []:
        if not row.get("manager_addr"):
            continue
        try:
            mgr = TFManager.connect(tuple(row["manager_addr"]), authkey)
            mgr.set(TFSparkNode.ABORT_KEY, str(reason))
            if row["job_name"] in ("ps", "evaluator"):
                mgr.get_queue("control").put(None, block=False)
            reached[row["executor_id"]] = (row, mgr)
        except Exception as e:
            logger.warning(
                "abort: could not reach %s:%s: %s", row["job_name"], row["task_index"], e
            )
    return reached


class TFCluster:
    """Handle to a running cluster; constructed by :func:`run`."""

    def __init__(self, sc, cluster_info, cluster_meta, input_mode, server, launch_thread, tf_status, num_workers, worker_executor_ids, registry=None):
        self.sc = sc
        self.cluster_info = cluster_info
        self.cluster_meta = cluster_meta
        self.input_mode = input_mode
        self.server = server
        self.launch_thread = launch_thread
        self.tf_status = tf_status
        self.num_workers = num_workers
        self.worker_executor_ids = worker_executor_ids
        self.queues = cluster_meta["queues"]
        # membership truth: constructed by run() (journal-backed when a
        # registry_dir was given); direct constructions get an in-memory one
        if registry is None:
            registry = membership.MembershipRegistry()
            registry.begin_generation(
                {r["executor_id"]: (r["job_name"], r["task_index"]) for r in cluster_info or []}
            )
        self.registry = registry
        for row in cluster_info or []:
            # idempotent: the reservation server already joined registered
            # rows; this covers directly-constructed clusters
            self.registry.join(
                row["executor_id"], job_name=row["job_name"], task_index=row["task_index"]
            )
        self._monitor_stop = None
        self._start_monitor()

    # -- failure watchdog ------------------------------------------------------

    def _start_monitor(self, interval=None, stale_secs=None):
        """Driver-side watchdog, registry-driven: every liveness signal is a
        lease transition on :attr:`registry`, and failure is lease *expiry*
        (VERDICT r2 item 7; the reference only polled error queues from feed
        tasks and at teardown, TFCluster.py:136-144,178-183).

        Signals, in priority order per node: (a) the error queue (peeked
        non-destructively — a posted traceback stays visible to the shutdown
        path), (b) a final ``child_status`` → ``registry.leave`` (clean
        release), (c) the child heartbeat counter → ``registry.renew`` —
        renewal happens only when the counter *advances*, so a SIGKILLed
        child's frozen counter stops renewing and its lease expires after
        the TTL (``TOS_HEARTBEAT_STALE``). Beat delivery is tiered: nodes
        covered by a live heartbeat-aggregation window
        (:func:`registry.plan_aggregation_tree`) are renewed from the
        aggregator's summary — O(sqrt N) driver sockets — and fall back to
        direct channel polls when their aggregator goes quiet. Expiries land
        in ``tf_status`` (checked by feeders, the shutdown join loop, and
        :meth:`check_errors`) with the executor id in the message, which is
        what ``elastic.classify_failure`` attributes ``lease_expired``
        events from.

        The ``control.driver_crash`` chaos site is consulted here: firing it
        discards the in-memory registry without a parting commit and
        recovers a fresh one from the journal, exactly as a restarted driver
        process would (:meth:`_simulate_driver_restart`).
        """
        interval = interval or float(os.environ.get("TOS_MONITOR_INTERVAL", "3"))
        stale_secs = stale_secs or float(os.environ.get("TOS_HEARTBEAT_STALE", "30"))
        self.registry.ttl = float(stale_secs)
        stop = threading.Event()
        self._monitor_stop = stop
        channels = {}
        rows_by_eid = {
            r["executor_id"]: r for r in self.cluster_info or [] if r.get("manager_addr")
        }
        tree = (
            membership.plan_aggregation_tree(rows_by_eid.values())
            if membership.aggregation_enabled(len(rows_by_eid))
            else {}
        )
        window_secs = membership.WINDOW_SECS
        # a window is live while its counter keeps changing; after this long
        # without a change the aggregator is presumed dead and its members
        # fall back to direct polls
        window_horizon = 3.0 * window_secs + interval
        window_state = {}  # aggregator eid -> (window counter, monotonic seen)

        def _connect(eid):
            import socket as _socket

            mgr = channels.get(eid)
            if mgr is None:
                # cheap bounded reachability probe first: BaseManager.connect
                # has no timeout, and one unreachable (NAT'd) node must not
                # stall the single monitor thread for the OS connect timeout
                # every cycle
                addr = tuple(rows_by_eid[eid]["manager_addr"])
                with _socket.create_connection(addr, timeout=2):
                    pass
                mgr = TFManager.connect(addr, self.cluster_meta["authkey"])
                channels[eid] = mgr
            return mgr

        def _node_error(eid):
            """Fetch a posted traceback from one node (non-destructive)."""
            row = rows_by_eid[eid]
            tb = TFSparkNode.peek_error(_connect(eid))
            if tb is not None:
                return "node {}:{} failed:\n{}".format(row["job_name"], row["task_index"], tb)
            return None

        def _preempted_problem(eid):
            """A child committed a ``preempted`` parting status: its durable
            ``leave`` above IS the lease handoff; the message wording (the
            word "preempted" + "(executor N)") is what
            ``elastic.classify_failure`` attributes ``preemption`` events
            from — first-class, never blacklisted, never budget-charged."""
            row = rows_by_eid.get(eid)
            job, task = (
                (row["job_name"], row["task_index"]) if row else ("worker", "?")
            )
            obs_tracing.event(
                "node_preempted", executor=eid, job=job, task_index=task
            )
            return "node {}:{} preempted (executor {})".format(job, task, eid)

        def _poll_direct(eid):
            """Direct channel poll: error → status(leave) → beat(renew)."""
            problem = _node_error(eid)
            if problem is not None:
                return problem
            mgr = _connect(eid)
            status = mgr.get("child_status")
            if status is not None:
                self.registry.leave(eid, reason=str(status))
                if str(status) == "preempted":
                    return _preempted_problem(eid)
                return None
            self.registry.renew(eid, beat=mgr.get("heartbeat"))
            return None

        def _apply_window(agg_eid):
            """Read one aggregator's window summary; returns the set of
            member eids it covered (empty → stale, members poll directly)."""
            import json as _json

            raw = _connect(agg_eid).get(membership.WINDOW_KEY)
            if not raw:
                return set(), {}
            summary = _json.loads(raw)
            now = _time.monotonic()
            prev = window_state.get(agg_eid)
            if prev is None or prev[0] != summary.get("window"):
                window_state[agg_eid] = (summary.get("window"), now)
            elif now - prev[1] > window_horizon:
                return set(), {}  # aggregator stopped publishing
            # members the summary carries nothing for are NOT covered: the
            # aggregator could not reach their channel (or the child has not
            # beaten yet), and renewing here would keep a dead executor's
            # lease alive forever. They fall through to the direct-poll
            # path, where an unreachable channel stops renewals and the
            # lease expires after the TTL.
            statuses, beats, flagged = membership.window_coverage(
                summary, [e for e in tree[agg_eid] if e in rows_by_eid]
            )
            covered, problems = set(), {}
            for eid in flagged:
                try:
                    problem = _node_error(eid)
                except Exception:
                    continue
                if problem is not None:
                    problems[eid] = problem
            for eid, status in statuses.items():
                if eid in problems:
                    continue
                covered.add(eid)
                self.registry.leave(eid, reason=str(status))
                if str(status) == "preempted":
                    problems[eid] = _preempted_problem(eid)
            for eid, beat in beats.items():
                if eid in problems:
                    continue
                covered.add(eid)
                self.registry.renew(eid, beat=beat)
            return covered, problems

        registry_errors = obs_registry.counter(
            "watchdog_registry_errors_total",
            help="watchdog registry operations that raised (journal I/O, fencing)",
        )

        def _monitor():
            reported = set()
            poll_errors_logged = set()  # log an unreachable channel once per node
            registry_error_logged = [False]  # log a registry I/O failure once

            def _registry_failed(e, what):
                """A registry operation raised inside the watchdog loop: count
                it, log once, and keep the thread alive — an unwritable journal
                dir must not silently end all failure detection."""
                registry_errors.inc()
                if not registry_error_logged[0]:
                    registry_error_logged[0] = True
                    logger.warning("watchdog: %s failed: %s", what, e)

            while not stop.wait(interval):
                if chaos.active and chaos.fire("control.driver_crash"):
                    try:
                        self._simulate_driver_restart()
                    except Exception as e:
                        _registry_failed(e, "driver-restart recovery")
                covered, problems = set(), {}
                for agg_eid in tree:
                    try:
                        got, agg_problems = _apply_window(agg_eid)
                    except Exception:
                        continue  # aggregator unreachable: members poll directly
                    covered |= got
                    problems.update(agg_problems)
                for eid in rows_by_eid:
                    if eid in covered or eid in reported or eid in problems:
                        continue
                    try:
                        problem = _poll_direct(eid)
                    except Exception as e:
                        # channel unreachable: shutdown's concern — but count
                        # it, so a node the watchdog can never see is visible
                        obs_registry.counter(
                            "watchdog_poll_errors_total",
                            help="watchdog node polls that raised (channel unreachable)",
                        ).inc()
                        if eid not in poll_errors_logged:
                            poll_errors_logged.add(eid)
                            row = rows_by_eid[eid]
                            logger.debug(
                                "watchdog: cannot poll node %s:%s: %s",
                                row["job_name"], row["task_index"], e,
                            )
                        continue
                    poll_errors_logged.discard(eid)
                    if problem:
                        problems[eid] = problem
                try:
                    expired = self.registry.expire_stale()
                except membership.StaleEpochError as e:
                    # a newer driver generation fenced this registry: every
                    # further durable write will refuse, so surface the
                    # takeover to the job instead of dying silently
                    expired = []
                    _registry_failed(e, "lease expiry")
                    self.tf_status.setdefault(
                        "error", "watchdog registry fenced: {}".format(e)
                    )
                except Exception as e:
                    expired = []
                    _registry_failed(e, "lease expiry")
                for eid, age in expired:
                    if eid in reported or eid in problems:
                        continue
                    row = rows_by_eid.get(eid)
                    job, task = (
                        (row["job_name"], row["task_index"]) if row else ("worker", "?")
                    )
                    # wording carries three contracts: "stopped heartbeating"
                    # (historical operator-facing phrasing), "lease expired"
                    # (elastic's lease_expired classification), and
                    # "(executor N)" (elastic's id attribution)
                    problems[eid] = (
                        "node {}:{} stopped heartbeating: lease expired after "
                        "{:.0f}s without renewal (executor {})".format(job, task, age, eid)
                    )
                    # the watchdog verdict is a black-box moment: stamp it on
                    # the trace (the merged timeline shows the kill -> expiry
                    # -> relaunch chain) and flush the driver's flight shard
                    obs_tracing.event(
                        "lease_expired", executor=eid, job=job, task_index=task,
                        age_s=round(age, 3),
                    )
                    obs_flight.dump("lease_expired:executor{}".format(eid))
                for eid in sorted(p for p in problems if p not in reported):
                    reported.add(eid)
                    logger.error("watchdog: %s", problems[eid])
                    self.tf_status.setdefault("error", problems[eid])

        threading.Thread(target=_monitor, name="tos-watchdog", daemon=True).start()

    def _simulate_driver_restart(self):
        """``control.driver_crash``: drop the registry with no parting commit
        (a crash does not say goodbye) and bring up a replacement the way a
        restarted driver process would — journal replay, live-lease
        re-adoption, epoch bump (fencing any stale writer). Executors are
        untouched: their children keep training, their leases keep renewing
        against the recovered registry. Rows the journal had not yet
        captured (or with no journal at all) are re-adopted from the
        assembly snapshot — their in-flight REG already proved them alive."""
        old = self.registry
        logger.warning(
            "chaos: control.driver_crash — dropping registry (epoch %d) and "
            "recovering from journal %s", old.epoch, old.journal_dir,
        )
        old.crash()
        self.registry = membership.MembershipRegistry.recover(
            old.journal_dir, ttl=old.ttl, fallback_epoch=old.epoch
        )
        for row in self.cluster_info or []:
            if row["executor_id"] not in self.registry.members():
                self.registry.join(
                    row["executor_id"],
                    job_name=row["job_name"],
                    task_index=row["task_index"],
                )
        obs_registry.counter(
            "registry_driver_restarts_total",
            help="driver registry crash/recover cycles (chaos or real)",
        ).inc()

    def _current_rows(self):
        """Freshest node rows. Real Spark retries a failed launch task, and
        the retry re-registers with a NEW channel address (idempotent REG
        replaces the row server-side, reservation.Reservations.add) — so for
        teardown/abort purposes the reservation server's live view supersedes
        the assembly-time ``cluster_info`` snapshot; otherwise an abort posted
        to a crashed node's OLD channel would miss the retry's fresh child."""
        try:
            rows = self.server.reservations.get()
            if rows:
                return rows
        except Exception:
            pass
        return self.cluster_info

    def check_errors(self):
        """Raise if the watchdog (or the launch path) recorded a node
        failure; cheap enough to call between training epochs."""
        if self.tf_status.get("error"):
            raise RuntimeError("cluster failed: {}".format(self.tf_status["error"]))

    # -- data plane -----------------------------------------------------------

    def train(self, dataRDD, num_epochs=0, feed_timeout=600, qname="input"):
        """Feed data to the cluster for training (InputMode.SPARK only).

        ``dataRDD`` may be (reference TFCluster.py:63-94):

        * an RDD — fed for ``num_epochs`` epochs; blocks until consumed or
          training requests a stop;
        * a DStream (anything with ``foreachRDD``) — every micro-batch is fed
          as it arrives; returns immediately (the streaming context drives
          the feeding; stop via ``shutdown(ssc)`` or a STOP on the control
          plane, reference TFCluster.py:83-85);
        * an iterable/generator of RDDs — micro-batches fed sequentially
          until exhausted or :attr:`stop_requested`.
        """
        assert self.input_mode == InputMode.SPARK, "train() requires InputMode.SPARK"
        assert dataRDD is not None, "dataRDD is required"
        task = TFSparkNode.train(
            self.cluster_info, self.cluster_meta, feed_timeout=feed_timeout, qname=qname
        )

        if hasattr(dataRDD, "foreachRDD"):  # DStream-equivalent
            logger.info("feeding training data from a stream (micro-batches)")

            # exactly ONE positional arg: pyspark's foreachRDD inspects
            # co_argcount and passes (batch_time, rdd) to 2-arg functions —
            # and defaulted params count, so `task` must be a closure
            def _feed_micro_batch(rdd):
                if not self.stop_requested:
                    rdd.foreachPartition(task)

            dataRDD.foreachRDD(_feed_micro_batch)
            return

        if not hasattr(dataRDD, "foreachPartition"):  # iterable of RDDs
            logger.info("feeding training data from an RDD iterator")
            for rdd in dataRDD:
                if self.stop_requested:
                    logger.info("stop requested; ending stream feed")
                    break
                rdd.foreachPartition(task)
            return

        logger.info("feeding training data (epochs=%s)", num_epochs)
        assert num_epochs is None or num_epochs >= 0, "num_epochs cannot be negative"
        if not num_epochs:
            # unspecified: feed "many" epochs and rely on the training loop to
            # terminate the feed at its target step count (reference
            # TFCluster.py:88-92 picks the same arbitrary 10)
            num_epochs = 10
        rdd = dataRDD
        if num_epochs > 1:
            rdd = self.sc.union([dataRDD] * num_epochs)
        rdd.foreachPartition(task)

    def inference(self, dataRDD, feed_timeout=600, qname="input", qname_out="output"):
        """Feed an RDD for inference; returns a (lazy) RDD of results with a
        1:1 input:output contract (reference TFCluster.py:96-115)."""
        assert self.input_mode == InputMode.SPARK, "inference() requires InputMode.SPARK"
        assert dataRDD is not None, "dataRDD is required"
        return dataRDD.mapPartitions(
            TFSparkNode.inference(
                self.cluster_info, self.cluster_meta, feed_timeout=feed_timeout,
                qname=qname, qname_out=qname_out,
            )
        )

    # -- teardown -------------------------------------------------------------

    @property
    def stop_requested(self):
        """True once any node (or an external tool like utils/stop_cluster)
        sent STOP on the control plane — streaming feeds poll this."""
        return self.server.stop_requested

    def shutdown(self, ssc=None, grace_secs=0, timeout=259200):
        """Stop the cluster: end-of-feed to every worker, wait for the launch
        job, stop driver-managed roles, surface any node error
        (reference TFCluster.py:117-202; the 3-day default timeout mirrors
        its SIGALRM watchdog, TFCluster.py:136-144).

        ``ssc``: a streaming context feeding this cluster — stopped
        gracefully first so queued micro-batches drain before the end-of-feed
        markers go out (reference streaming-aware shutdown,
        mnist_spark_streaming.py:141-144).
        """
        logger.info("shutting down cluster")
        if ssc is not None:
            try:
                ssc.stop(stopSparkContext=False, stopGraceFully=True)
            except TypeError:  # non-pyspark signature
                ssc.stop()

        role_errors = []
        try:
            if self.input_mode == InputMode.SPARK:
                self._shutdown_workers(grace_secs)
        finally:
            # even when a worker surfaced an error, stop driver-managed roles,
            # reap the launch job, and release the reservation server — a
            # long-lived driver must be able to retry cluster.run without
            # leaking server threads/sockets. ps/evaluator error queues are
            # peeked here: nothing else ever reads them (workers surface
            # their errors through the feed tasks / _shutdown_workers).
            for row in self.cluster_info:
                if row.get("manager_addr"):
                    try:
                        mgr = TFManager.connect(tuple(row["manager_addr"]), self.cluster_meta["authkey"])
                        if row["job_name"] in ("ps", "evaluator"):
                            tb = TFSparkNode.peek_error(mgr)
                            if tb is not None:
                                role_errors.append(
                                    "node {}:{}:\n{}".format(row["job_name"], row["task_index"], tb)
                                )
                        mgr.get_queue("control").put(None, block=True)
                    except Exception as e:
                        logger.warning(
                            "could not stop %s:%s at %s: %s",
                            row["job_name"], row["task_index"], row["manager_addr"], e,
                        )
            # poll-join so a watchdog-detected node failure cuts the wait
            # short instead of riding out the full timeout

            deadline = _time.time() + timeout
            while self.launch_thread.is_alive() and _time.time() < deadline:
                self.launch_thread.join(timeout=1.0)
                if self.tf_status.get("error"):
                    break
            self.server.stop()
            if self._monitor_stop is not None:
                self._monitor_stop.set()
        if self.launch_thread.is_alive() and not self.tf_status.get("error"):
            raise RuntimeError("cluster did not shut down within {}s".format(timeout))
        if self.tf_status.get("error"):
            raise RuntimeError(
                "cluster failed: {}{}".format(
                    self.tf_status["error"],
                    "\nadditionally, driver-managed role error(s):\n" + "\n".join(role_errors)
                    if role_errors
                    else "",
                )
            )
        if role_errors:
            raise RuntimeError("error(s) in driver-managed roles:\n" + "\n".join(role_errors))
        logger.info("cluster shut down cleanly")

    def _shutdown_workers(self, grace_secs):
        """Post end-of-feed directly to every worker's queues over its TCP
        channel and wait for each jax child to wind down.

        Deterministic replacement for the reference's shutdown-by-Spark-tasks
        (TFCluster.py:174-176 + TFSparkNode.py:534-588), which relied on the
        scheduler spreading exactly one quick task per executor; here every
        worker is addressed explicitly, so no node can miss (or double-get)
        its end-of-feed marker.

        When a worker's channel is NOT reachable from the driver (NAT'd real
        clusters: executor TCP ports are often driver-opaque), shutdown falls
        back to the reference's design — one
        :class:`~tensorflowonspark_tpu_torch.TFSparkNode._ShutdownPartitionTask`
        scattered per executor, each posting end-of-feed over its own
        executor-local channel.
        """
        workers = _worker_rows(self.cluster_info)
        channels = []
        unreachable = []
        for row in workers:
            try:
                mgr = TFManager.connect(tuple(row["manager_addr"]), self.cluster_meta["authkey"])
                mgr.get_queue("input").put(None, block=True)
                channels.append((row, mgr))
            except Exception as e:
                logger.warning(
                    "could not reach %s:%s for shutdown: %s", row["job_name"], row["task_index"], e
                )
                unreachable.append(row)
        if unreachable:
            self._shutdown_by_spark_tasks(grace_secs, unreachable)
        errors = []
        # one absolute budget shared across every channel wait
        deadline = resilience.Deadline(max(grace_secs, 60))
        tick = resilience.Backoff(base=0.1, factor=1.0, max_delay=0.1, jitter=0.0)
        for row, mgr in channels:
            for _ in tick.attempts(deadline=deadline):
                if mgr.get("child_status") is not None:
                    break
            try:
                eq = mgr.get_queue("error")
                if not eq.empty():
                    tb = eq.get(block=False)
                    eq.put(tb)  # keep visible (reference peek-and-requeue,
                    eq.task_done()  # TFSparkNode.py:576-582)
                    errors.append("node {}:{}:\n{}".format(row["job_name"], row["task_index"], tb))
            except Exception:
                pass
            # drain whatever the child never consumed: shared-memory chunks
            # in an abandoned queue would otherwise pin /dev/shm RAM until
            # the day-scale janitor (a dead child can't unlink its segments)
            try:
                TFSparkNode.drain_queue(mgr, "input")
            except Exception:
                pass
            mgr.set("state", "stopped")
        if errors:
            raise RuntimeError("error(s) in cluster nodes:\n" + "\n".join(errors))

    def _shutdown_by_spark_tasks(self, grace_secs, rows):
        """Reference-style shutdown scatter (TFCluster.py:174-176): one Spark
        task per executor posts end-of-feed over the executor-LOCAL channel —
        the path that still works when executor TCP is unreachable from the
        driver. Tasks landing on already-stopped nodes are no-ops (an extra
        end-of-feed marker in a drained queue)."""
        logger.warning(
            "falling back to Spark-task shutdown for %d unreachable worker(s): %s",
            len(rows),
            ", ".join("{}:{}".format(r["job_name"], r["task_index"]) for r in rows),
        )
        n = max(self.num_workers, len(rows))
        try:
            # local backend: pin task i to executor i so every node gets its
            # marker; pyspark lacks the kwarg and relies on the scheduler
            # spreading quick tasks (the reference's assumption)
            shutdown_rdd = self.sc.parallelize(range(n), n, pin_to_executors=True)
        except TypeError:
            shutdown_rdd = self.sc.parallelize(range(n), n)
        shutdown_rdd.foreachPartition(
            TFSparkNode.shutdown(self.cluster_info, self.cluster_meta, grace_secs=grace_secs)
        )

    def abort(self, reason="aborted by driver", wait_secs=60):
        """Forcibly tear the cluster down so the same SparkContext can
        relaunch: post an abort reason on every node channel (the
        executor-side abort watcher kills the jax child, freeing the executor
        slot), release parked ps/evaluator tasks, then wait for the nodes to
        report stopped.

        Unlike :meth:`shutdown` this never raises on node errors — it is the
        teardown half of :func:`run_with_recovery`, called when a failure has
        already been detected. The reference stopped at detection (SystemExit
        on the feed path, reference TFCluster.py:178-183); deterministic
        reclaim + relaunch is the TPU-native recovery story.
        """

        self.tf_status.setdefault("error", str(reason))
        reached = _abort_nodes(self._current_rows(), self.cluster_meta["authkey"], reason)
        pending = dict(reached)
        tick = resilience.Backoff(base=0.5, factor=1.0, max_delay=0.5, jitter=0.0)
        for _ in tick.attempts(deadline=resilience.Deadline(wait_secs)):
            for eid in list(pending):
                row, mgr = pending[eid]
                try:
                    if mgr.get("state") == "stopped":
                        pending.pop(eid)
                except Exception:
                    pending.pop(eid)  # channel gone: the node is down
            if not pending:
                break
        for eid, (row, _) in pending.items():
            logger.warning(
                "abort: node %s:%s did not confirm stop within %ss",
                row["job_name"], row["task_index"], wait_secs,
            )
        self.launch_thread.join(timeout=wait_secs)
        self.server.stop()
        if self._monitor_stop is not None:
            self._monitor_stop.set()
        logger.info("cluster aborted: %s", reason)

    def preempt(self, reason="preempted by driver", workers=None):
        """Post a preemption *warning* on worker channels — the
        driver-initiated sibling of a platform SIGTERM grace window.

        Each jax child's heartbeat notices the ``preempt`` key within one
        beat and runs its warned-shutdown path: drain in-flight async
        checkpoints, flush metrics, commit a ``preempted`` parting status
        (which the watchdog turns into a durable registry ``leave``), and
        exit clean. Unlike :meth:`abort` this is a *handoff*, not a
        teardown: the recovery ladder classifies the resulting loss as a
        first-class ``preemption`` (no blacklist, no restart-budget charge)
        and relaunches — the regrow path uses exactly this to restart onto
        a larger mesh without losing the step in flight.

        ``workers`` restricts the warning to specific executor ids.
        Returns the executor ids the warning reached.
        """
        posted = []
        for row in _worker_rows(self._current_rows()):
            if workers is not None and row["executor_id"] not in workers:
                continue
            try:
                mgr = TFManager.connect(
                    tuple(row["manager_addr"]), self.cluster_meta["authkey"]
                )
                mgr.set("preempt", str(reason))
                posted.append(row["executor_id"])
            except Exception as e:
                logger.warning(
                    "preempt: could not reach %s:%s: %s",
                    row["job_name"], row["task_index"], e,
                )
        if posted:
            logger.info(
                "preemption warning posted to executors %s: %s", posted, reason
            )
        return posted

    def wait_for_completion(self, poll_secs=1.0, timeout=None):
        """Block until every worker node retires (channel state ``"stopped"``)
        or a failure is recorded in ``tf_status`` (InputMode.TENSORFLOW).
        Returns True on completion/failure, False on timeout.

        Waiting on the *launch thread* instead would hang any cluster with
        ps/evaluator roles: those tasks park on their control queues until
        :meth:`shutdown` posts the release, so the launch job outlives
        training by design (reference ps wait loop, TFSparkNode.py:373-390).
        Worker channel state is the true completion signal; launch-thread
        exit also ends the wait. On a NAT'd cluster whose worker channels
        the driver cannot reach AND with a parked ps/evaluator role, neither
        signal can fire — pass ``timeout`` to bound the wait there.
        """

        mgrs = {}  # keyed by channel address: a task retry re-registers anew
        tick = resilience.Backoff(base=poll_secs, factor=1.0, max_delay=poll_secs, jitter=0.0)
        for _ in tick.attempts(deadline=resilience.Deadline(timeout)):
            if self.tf_status.get("error"):
                return True
            if not self.launch_thread.is_alive():
                return True
            done = True
            # rows re-read each cycle: a Spark task retry may have replaced a
            # node's channel address server-side mid-wait
            for row in _worker_rows(self._current_rows()):
                addr = tuple(row["manager_addr"])
                try:
                    mgr = mgrs.get(addr)
                    if mgr is None:
                        mgr = mgrs[addr] = TFManager.connect(
                            addr, self.cluster_meta["authkey"]
                        )
                    if mgr.get("state") != "stopped":
                        done = False
                except Exception:
                    mgrs.pop(addr, None)
                    done = False  # unreachable: rely on launch-thread exit
            if done:
                return True
        return False

    # -- observability --------------------------------------------------------

    def tensorboard_url(self):
        """URL of the profiler/TensorBoard server on the chief, if one was
        launched (reference TFCluster.py:204-209)."""
        for row in self.cluster_info:
            if row.get("tb_port"):
                return "http://{}:{}".format(row["host"], row["tb_port"])
        return None

    def metrics(self, include_driver=True):
        """One merged metrics snapshot for the whole cluster.

        Reads each reachable node channel's published snapshots (the jax
        child's ``obs_snapshot`` lane plus the feed tasks' accumulated
        ``obs_feeder`` lane), merges them with the driver's own registry
        (reservation timings, client retries), and returns the aggregation
        plane's snapshot dict with one extra key: ``"nodes"`` maps
        ``"job:index"`` to that node's own merged view, so per-node detail
        survives the cluster-level summing of counters/gauges.

        Unreachable channels (NAT'd executors) simply contribute nothing —
        same degradation story as :meth:`_shutdown_workers`. The result is
        JSON-able and feeds both exporters directly::

            obs.exporter.MetricsHTTPServer(cluster.metrics, port=9100).start()
        """
        snaps = []
        nodes = {}
        for row in self._current_rows() or []:
            if not row.get("manager_addr"):
                continue
            try:
                mgr = TFManager.connect(
                    tuple(row["manager_addr"]), self.cluster_meta["authkey"]
                )
                node_snaps = obs_aggregate.read_channel_snapshots(mgr)
            except Exception as e:
                logger.debug(
                    "metrics: channel %s:%s unreachable: %s",
                    row["job_name"], row["task_index"], e,
                )
                continue
            if node_snaps:
                merged_node = obs_aggregate.merge_snapshots(node_snaps)
                nodes["{}:{}".format(row["job_name"], row["task_index"])] = merged_node
                snaps.append(merged_node)
        if include_driver:
            snaps.append(obs_registry.snapshot())
        merged = obs_aggregate.merge_snapshots(snaps)
        merged["nodes"] = nodes
        return merged


def run_with_recovery(
    sc,
    map_fun,
    tf_args,
    num_executors,
    max_relaunches=2,
    poll_secs=1.0,
    shutdown_timeout=600,
    completion_timeout=None,
    feed_fn=None,
    **run_kwargs,
):
    """Train with automatic failure recovery: run → detect (watchdog / launch
    error / failed feed) → :meth:`TFCluster.abort` the survivors → relaunch →
    ``map_fun`` resumes from its latest checkpoint.

    The reference stopped at *detection* — on a node error the feed path
    raised and the docs told the operator to resubmit the job (reference
    TFCluster.py:178-183); the hard half (resuming the trajectory from the
    latest checkpoint) was delegated to TF's ``load_weights_on_restart``.
    Here the whole loop is driver-side: ``map_fun`` must pick up from
    ``checkpoint.restore_latest(model_dir)`` when one exists — the
    contract proven end-to-end in ``tests/test_resume.py`` — and this helper
    supplies detection, deterministic teardown, and relaunch around it.
    Resume prefers **manifest-verified** checkpoints: ``restore_latest``
    cheap-checks each candidate against its ``MANIFEST.json`` (written last
    and rename-published by the async engine,
    :mod:`tensorflowonspark_tpu_torch.ckpt`), skipping torn or bitrotten newest
    checkpoints with a logged reason instead of attempting doomed restores.
    Under replicated data parallelism every rank holds the whole state, so a
    relaunch at another worker count restores the same checkpoint.

    Two input modes:

    * ``InputMode.TENSORFLOW`` (the perf path: nodes read their own data) —
      leave ``feed_fn`` unset; each attempt waits for worker completion.
    * ``InputMode.SPARK`` — pass ``feed_fn(cluster)``, the caller's feed
      loop (``cluster.train(...)`` calls). The feed RDD's lineage belongs to
      the caller, so only the caller can re-feed: on a node death mid-feed
      the feed task raises (feed timeout / watchdog), the attempt is
      aborted, and ``feed_fn`` is re-invoked FROM THE START against the
      relaunched cluster — ``map_fun`` resumes from its checkpoint and
      trains on the re-fed stream (use closure state inside ``feed_fn`` for
      partial re-feeds). After ``feed_fn`` returns, ``check_errors()``
      catches failures that raced the feed's completion.

    ``completion_timeout`` bounds each attempt's completion wait for the one
    topology where no completion signal can reach the driver (NAT'd worker
    channels + a parked ps/evaluator keeping the launch job alive — see
    :meth:`TFCluster.wait_for_completion`); on expiry the attempt proceeds
    straight to :meth:`TFCluster.shutdown`, whose Spark-task fallback can
    reach NAT'd nodes. Leave ``None`` for reachable clusters — a legitimate
    training run can take arbitrarily long.

    The attempt loop itself is the **recovery ladder**
    (:func:`tensorflowonspark_tpu_torch.elastic.run_ladder`): failures are
    classified into a :class:`~tensorflowonspark_tpu_torch.elastic.FailureLedger`,
    executors with repeated attributable losses are blacklisted (after a
    preflight health probe), and the relaunch shrinks to the surviving
    capacity — ``map_fun`` restoring the same checkpoint at the smaller
    world size. Ladder knobs (``min_workers``,
    ``blacklist_after``, ``window_secs``, ``preflight``, ``regrow``) pass
    through ``**run_kwargs``; the defaults reproduce the historical
    behaviour for single transient faults (one failure → full-size
    relaunch).

    Returns the number of relaunches performed (0 = clean first run).
    """
    mode = run_kwargs.get("input_mode", InputMode.SPARK)
    if mode != InputMode.TENSORFLOW and feed_fn is None:
        raise ValueError(
            "run_with_recovery in SPARK mode needs feed_fn=<your feed loop>; "
            "without a feed, use input_mode=InputMode.TENSORFLOW"
        )
    if mode == InputMode.TENSORFLOW and feed_fn is not None:
        raise ValueError("feed_fn requires input_mode=InputMode.SPARK")
    from tensorflowonspark_tpu_torch import elastic

    result = elastic.run_ladder(
        sc,
        map_fun,
        tf_args,
        num_executors,
        max_relaunches=max_relaunches,
        poll_secs=poll_secs,
        shutdown_timeout=shutdown_timeout,
        completion_timeout=completion_timeout,
        feed_fn=feed_fn,
        **run_kwargs,
    )
    return result.relaunches


def build_cluster_template(num_executors, num_ps=0, master_node="chief", eval_node=False,
                           blacklist=None):
    """executor_id → (job_name, task_index), in the reference's role order
    ps → chief → evaluator → worker (TFCluster.py:252-267).

    ``blacklist`` (executor ids) excludes known-bad hosts from the
    assignment: roles are laid onto the first ``num_executors`` ids counting
    from 0 and *skipping* blacklisted ones, so a relaunch after the recovery
    ladder condemns an executor still gets ``num_executors`` healthy nodes
    (:mod:`~tensorflowonspark_tpu_torch.elastic`).
    """
    if master_node is not None and master_node not in ("chief", "master"):
        # catches stringified-None and typos before they become silent
        # do-nothing roles in a live cluster
        raise ValueError(
            "master_node must be 'chief', 'master', or None; got {!r}".format(master_node)
        )
    roles = ["ps"] * num_ps
    if master_node:
        roles.append(master_node)
    if eval_node:
        roles.append("evaluator")
    num_workers = num_executors - len(roles)
    if num_workers < 0 or (num_workers == 0 and not master_node):
        raise ValueError(
            "num_executors={} too small for num_ps={}, master_node={!r}, eval_node={}".format(
                num_executors, num_ps, master_node, eval_node
            )
        )
    roles.extend(["worker"] * num_workers)
    banned = frozenset(blacklist or ())
    template, counters = {}, {}
    executor_id = 0
    for job in roles:
        while executor_id in banned:
            executor_id += 1
        task_index = counters.get(job, 0)
        counters[job] = task_index + 1
        template[executor_id] = (job, task_index)
        executor_id += 1
    return template


def resolve_default_fs(sc):
    """Default filesystem for the cluster: the local backend exposes
    ``defaultFS`` directly; real pyspark answers through the JVM Hadoop conf
    (reference TFCluster.py:271-274)."""
    default_fs = getattr(sc, "defaultFS", None)
    if default_fs is None:
        try:  # real pyspark: ask the Hadoop conf
            default_fs = sc._jsc.hadoopConfiguration().get("fs.defaultFS")
        except Exception:
            default_fs = "file://"
    return default_fs


def run(
    sc,
    map_fun,
    tf_args,
    num_executors,
    num_ps=0,
    tensorboard=False,
    input_mode=InputMode.SPARK,
    log_dir=None,
    driver_ps_nodes=False,
    master_node="chief",
    reservation_timeout=600,
    queues=None,
    eval_node=False,
    env=None,
    jax_distributed=None,
    obs=None,
    blacklist=None,
    registry=None,
    registry_dir=None,
):
    """Start a cluster: one node per executor (reference TFCluster.py:212-380).

    ``env`` is propagated into every trainer child process (e.g.
    ``{"TOS_PLATFORM": "cpu"}`` for CPU test runs; the default platform is
    the GPU). ``jax_distributed`` keeps the JAX package's name so a driver
    script changes only its import: here it governs whether children join
    a multi-process **torch.distributed** world (NCCL on the card, gloo on
    the CPU; see ``TFNodeContext.initialize_distributed``); default: only
    when more than one training participant exists and no explicit override.
    ``obs`` toggles the observability plane cluster-wide (registry collection
    in children and feed tasks, snapshot publication, ``TFCluster.metrics()``
    content); default: the driver's ``TOS_OBS`` env setting (on unless
    ``TOS_OBS=0``).
    ``blacklist`` (executor ids) excludes known-bad executors: the template
    skips them, the launch RDD never pins a task to them, and the reservation
    server refuses a late registration from one — the recovery ladder's lever
    (:mod:`~tensorflowonspark_tpu_torch.elastic`).
    ``registry`` is an existing
    :class:`~tensorflowonspark_tpu_torch.registry.MembershipRegistry` to reuse
    (the recovery ladder passes one across attempts so the epoch and
    blacklist journal survive relaunches); ``registry_dir`` (env
    ``TOS_REGISTRY_DIR``) backs a fresh registry with an on-disk journal —
    the driver-restart survivability lever. With neither, membership is
    tracked in memory only.
    """
    if obs is None:
        obs = os.environ.get("TOS_OBS", "1") != "0"
    if driver_ps_nodes:
        raise NotImplementedError(
            "driver_ps_nodes: parameter servers have no TPU analogue; ps roles "
            "run on executors for API compatibility only (SURVEY.md §2.6)"
        )
    template = build_cluster_template(num_executors, num_ps, master_node, eval_node,
                                      blacklist=blacklist)
    executor_ids = sorted(template)
    num_workers = sum(1 for job, _ in template.values() if job in ("chief", "master", "worker"))
    worker_executor_ids = [
        eid for eid, (job, _) in template.items() if job in ("chief", "master", "worker")
    ]
    if jax_distributed is None:
        # default: any multi-worker cluster forms a torch.distributed world —
        # NCCL on the card, gloo on the CPU (see
        # TFNodeContext.initialize_distributed)
        jax_distributed = num_workers > 1
    logger.info("cluster template: %s", {e: "{}:{}".format(j, t) for e, (j, t) in template.items()})

    if registry is None:
        registry_dir = registry_dir or os.environ.get("TOS_REGISTRY_DIR") or None
        registry = membership.MembershipRegistry(
            ttl=float(os.environ.get("TOS_HEARTBEAT_STALE", "30")),
            journal_dir=registry_dir,
        )
    registry.begin_generation(template, target_size=num_executors)
    for eid in blacklist or ():
        # one membership truth: the caller's static blacklist is mirrored
        # into (and journaled by) the registry
        registry.blacklist(eid, reason="caller blacklist")

    server = reservation.Server(
        num_executors, expected_ids=executor_ids, blacklist=blacklist,
        registry=registry,
    )
    server_addr = server.start()

    default_fs = resolve_default_fs(sc)

    cluster_meta = {
        "id": random.getrandbits(64),
        "cluster_template": template,
        # the executors this relaunch left out: a survivor's card is placed
        # past theirs (TFNodeContext.card)
        "blacklist": sorted(blacklist or ()),
        "num_executors": num_executors,
        "server_addr": server_addr,
        "default_fs": default_fs,
        "queues": list(queues or TFManager.CONTROL_QUEUES),
        "input_mode": "spark" if input_mode == InputMode.SPARK else "tensorflow",
        "authkey": secrets.token_bytes(16),
        "reservation_timeout": reservation_timeout,
        # a driver-installed chaos plan rides the env lane so executors /
        # jax children on OTHER hosts (no shared os.environ) inherit it;
        # an explicit user-provided TOS_CHAOS_PLAN in env wins. The trace
        # context (TOS_TRACE_ID / parent span / TOS_TRACE_DIR) rides the
        # same lane: mint() is idempotent, so a ladder relaunch reuses the
        # trace_id and the whole recovery stays one causal timeline.
        "env": {
            **obs_tracing.mint(proc="driver"),
            **({chaos.ENV_VAR: chaos.plan().to_json()} if chaos.active else {}),
            **dict(env or {}),
        },
        "jax_distributed": bool(jax_distributed),
        "tensorboard": bool(tensorboard),
        "log_dir": log_dir,
        # the driver's feed-lane choice, honored on BOTH halves of the plane
        # (feed tasks capture it at construction; DataFeed.batch_results
        # reads it from ctx.cluster_meta)
        "feed_shm": TFSparkNode.FEED_SHM,
        "obs": bool(obs),
    }

    tf_status = {}
    # partition data = the executor ids to launch (non-contiguous under a
    # blacklist); pinning sends task i to executor executor_ids[i], so a
    # blacklisted executor hosts nothing
    kwargs = (
        {"pin_to_executors": executor_ids} if getattr(sc, "PIN_SUPPORTED", False) else {}
    )
    node_rdd = sc.parallelize(executor_ids, num_executors, **kwargs)
    launch_task = TFSparkNode.run(
        map_fun, tf_args, cluster_meta, cluster_meta["input_mode"], log_dir, cluster_meta["queues"]
    )

    def _start():
        try:
            node_rdd.foreachPartition(launch_task)
        except Exception as e:
            logger.error("node launch failed: %s", e)
            # first error wins (the watchdog may already have recorded the
            # root cause; an abort() records its reason the same way)
            tf_status.setdefault("error", str(e))

    launch_thread = threading.Thread(target=_start, name="tos-cluster-launch", daemon=True)
    launch_thread.start()

    try:
        cluster_info = server.await_reservations(tf_status, timeout=reservation_timeout)

        # duplicate-node sanity check (reference TFCluster.py:352-367)
        eids = [r["executor_id"] for r in cluster_info]
        if sorted(eids) != sorted(template.keys()):
            raise RuntimeError(
                "cluster assembled with wrong executor set: got {} expected {}".format(
                    sorted(eids), sorted(template.keys())
                )
            )
    except BaseException as e:
        # nodes that DID register have already spawned jax children pinning
        # their executor slots — abort them, or a retry of run() on the same
        # SparkContext would starve against our own leak
        try:
            _abort_nodes(
                server.reservations.get(), cluster_meta["authkey"],
                "cluster assembly failed: {}".format(e),
            )
        except Exception:
            pass
        server.stop()  # don't leak the listener thread/socket on failed assembly
        raise
    for row in sorted(cluster_info, key=lambda r: r["executor_id"]):
        logger.info(
            "node: executor=%d %s:%d @ %s:%s chips=%s",
            row["executor_id"], row["job_name"], row["task_index"],
            row["host"], row["port"], (row.get("gpu") or {}).get("num_chips"),
        )
    return TFCluster(
        sc, cluster_info, cluster_meta, input_mode, server, launch_thread, tf_status,
        num_workers, worker_executor_ids, registry=registry,
    )
