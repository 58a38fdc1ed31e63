"""Executor-side node runtime.

Capability-parity with /root/reference/tensorflowonspark/TFSparkNode.py, built
for the TPU process model. Per executor, the launch task:

1. maps its executor id to a (job_name, task_index) from the cluster template,
2. starts the per-executor IPC channel (local unix socket; TCP for
   driver-managed roles) and persists the reconnect record to the executor CWD,
3. registers with the driver's reservation server (host, rendezvous port,
   GPU count) and blocks until the whole cluster is assembled,
4. derives the torch.distributed world — rendezvous address, world size,
   rank — from the assembled cluster info (the ClusterSpec/TF_CONFIG
   analogue, reference TFSparkNode.py:277-299),
5. **spawns** the trainer child process that owns this node's card and runs
   the user's ``main_fun(args, ctx)``; the executor process itself never
   touches CUDA, so it stays light, reusable across Spark tasks, and safe
   to start children from (a CUDA context does not survive a fork; the
   reference's bg-process dispatch, TFSparkNode.py:339-395, generalized:
   *every* role runs in a child and the card is freed when the child exits).

Feeding/inference/shutdown closures are picklable task objects (Spark and the
local backend both ship them to executors by serialization).
"""

import logging
import os
import signal
import threading
import time
import traceback

from tensorflowonspark_tpu_torch import TFManager, TFNode, chaos, gpu_info, reservation, resilience, util
from tensorflowonspark_tpu_torch.marker import Chunk, EndPartition
from tensorflowonspark_tpu_torch.obs import aggregate as obs_aggregate
from tensorflowonspark_tpu_torch.obs import flight as obs_flight
from tensorflowonspark_tpu_torch.obs import registry as obs_registry
from tensorflowonspark_tpu_torch.obs import trace as obs_trace
from tensorflowonspark_tpu_torch.obs import tracing as obs_tracing

#: rows per proxied queue message on the feed plane (amortizes the Manager
#: round trip that was the reference's hot-loop bottleneck; overridable for
#: huge rows via env)
FEED_CHUNK_SIZE = int(os.environ.get("TOS_FEED_CHUNK", "100"))

#: ship chunk payloads through shared memory (columnar numpy segments; the
#: Manager carries only descriptors) — rows without a uniform numeric shape
#: fall back to pickled Chunks per chunk; TOS_FEED_SHM=0 disables the lane
FEED_SHM = os.environ.get("TOS_FEED_SHM", "1") == "1"


def _put_rows(q, rows, use_shm=None):
    """One feed-plane message: shared-memory columnar segment when the rows
    allow it, pickled Chunk otherwise."""
    if FEED_SHM if use_shm is None else use_shm:
        from tensorflowonspark_tpu_torch.shm import ShmChunk

        chunk = ShmChunk.from_rows(rows)
        if chunk is not None:
            q.put(chunk, block=True)
            return
    q.put(Chunk(rows), block=True)

logger = logging.getLogger(__name__)

#: Executor-process-global registry of live IPC channels, keyed by executor id.
#: Keeps the manager server process alive after the launch task returns (its
#: BaseManager finalizer would otherwise tear the channel down) and lets tasks
#: that land on this executor later reuse the handle — the reference's
#: module-global manager singleton (TFSparkNode.py:97-123).
_live_channels = {}

#: Executor-process-global registry of running heartbeat aggregators, keyed by
#: executor id. The aggregator thread outlives the launch task alongside its
#: channel; a Spark task retry (or a relaunch generation) on the same executor
#: must stop the previous one before electing anew — two aggregators publishing
#: independently-numbered windows on one channel would make the driver's
#: window-freshness check flap.
_live_aggregators = {}
_live_aggregators_lock = threading.Lock()


class TFNodeContext:
    """Context object handed to user ``main_fun(args, ctx)``.

    Field-parity with the reference's ctx (TFSparkNode.py:37-60: job_name,
    task_index, cluster_spec, defaultFS, working_dir, mgr, num_workers) plus
    the torch.distributed world: rendezvous address / rank / world size, the
    local GPU topology, and :attr:`device`, the ``torch.device`` this node
    trains on.
    """

    def __init__(
        self,
        executor_id,
        job_name,
        task_index,
        cluster_spec,
        defaultFS,
        working_dir,
        mgr=None,
        coordinator_address=None,
        num_processes=1,
        process_id=0,
        topology=None,
        cluster_meta=None,
        card_peers=None,
        lost=(),
    ):
        self.executor_id = executor_id
        self.worker_num = executor_id  # reference-compat alias
        self.job_name = job_name
        self.task_index = task_index
        self.cluster_spec = cluster_spec
        self.defaultFS = defaultFS
        self.working_dir = working_dir
        self.mgr = mgr
        self.coordinator_address = coordinator_address
        self.num_processes = num_processes
        self.process_id = process_id
        self.topology = topology or {}
        self.cluster_meta = cluster_meta or {}
        #: executor ids of the ranks of this node's world on its host (this
        #: node alone outside a world) and of the executors the cluster lost
        #: (blacklisted): what :meth:`card` places this node among
        self.card_peers = list(card_peers or [executor_id])
        self.lost = tuple(lost or ())

    @property
    def num_workers(self):
        """Number of training participants (chief/master + workers), reference
        TFSparkNode.py:58."""
        spec = self.cluster_spec or {}
        return (
            len(spec.get("chief", []))
            + len(spec.get("master", []))
            + len(spec.get("worker", []))
        )

    @property
    def distributed(self):
        return self.num_processes > 1

    def get_data_feed(self, train_mode=True, qname_in="input", qname_out="output", input_mapping=None):
        """The InputMode.SPARK consumer (reference TFNode.py:221)."""
        return TFNode.DataFeed(
            self.mgr, train_mode, qname_in, qname_out, input_mapping,
            use_shm=self.cluster_meta.get("feed_shm"),
        )

    def absolute_path(self, path):
        return TFNode.hdfs_path(self, path)

    @property
    def platform(self):
        """``"gpu"`` (default) or ``"cpu"``, from the cluster's env lane."""
        return os.environ.get(util.ENV_PLATFORM, "gpu")

    def card(self, cards):
        """This node's card on a host with ``cards`` visible cards: its
        executor's own, the same in every life whatever its rank, and never
        another rank's of its world (:func:`util.card_map`)."""
        return util.card_map(self.card_peers, cards, self.lost)[self.executor_id]

    @property
    def device(self):
        """The ``torch.device`` of this node: the CPU, or its card
        (:meth:`card`). Selecting ``"gpu"`` without a CUDA device raises."""
        if self.platform != "gpu":
            return util.select_device(self.platform)
        import torch

        cards = torch.cuda.device_count()  # NVML: no CUDA context yet
        return util.select_device(self.platform, self.card(cards) if cards else 0)

    def initialize_distributed(self):
        """Join the torch.distributed world derived from the reservations:
        NCCL on the card, gloo on the CPU, rendezvous over ``tcp://`` at the
        elected coordinator address, with this node's rank and world size.

        Call before any collective in multi-process runs; no-op for a single
        process. This is the TF_CONFIG/ClusterSpec replacement.
        """
        if self.num_processes <= 1:
            return
        import torch.distributed as dist

        if dist.is_initialized():
            return
        backend = "nccl" if self.device.type == "cuda" else "gloo"
        dist.init_process_group(
            backend,
            init_method="tcp://{}".format(self.coordinator_address),
            world_size=self.num_processes,
            rank=self.process_id,
        )
        logger.info(
            "torch.distributed world up (%s): %d processes, this is %d",
            backend, self.num_processes, self.process_id,
        )

    def mesh(self, axes=None):
        """The device mesh of this cluster over its ranks (one card each),
        with the axes ``axes`` (default ``{"dp": -1}``; see
        :mod:`tensorflowonspark_tpu_torch.parallel.mesh`). Ranks are grouped
        by the reservation's host, so ``dp`` crosses hosts and ``fsdp`` stays
        on one host. Joins the world first (a one-rank world for a single
        process)."""
        from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib

        device = self.device
        self.initialize_distributed()
        mesh_lib.ensure_world(device.type)
        return mesh_lib.build_mesh(axes, self._rank_devices(), device_type=device.type)

    def mesh_plan(self, axes=None):
        """The layout :meth:`mesh` gives ``axes``, as a plan with no process
        groups: built by this rank alone (not collective) and without
        touching the card, so it shards the input by the data axes before
        the trainer's pipeline forks its workers."""
        from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib

        return mesh_lib.build_mesh(axes, self._rank_devices(), device_type="cpu", plan=True)

    def _rank_devices(self):
        from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib

        spec = self.cluster_spec or {}
        hosts = [entry.rsplit(":", 1)[0] for role in ("chief", "master", "worker") for entry in spec.get(role, [])]
        if len(hosts) != self.num_processes:
            hosts = [None] * self.num_processes
        return [mesh_lib.RankDevice(r, h) for r, h in enumerate(hosts)]


def _role_rank(job_name):
    # template order mirrors the reference: ps → chief → evaluator → worker
    return {"ps": 0, "chief": 1, "master": 1, "evaluator": 2, "worker": 3}.get(job_name, 3)


def _participants(cluster_info):
    """Training participants (chief first, then workers by task_index)."""
    rows = [r for r in cluster_info if r["job_name"] in ("chief", "master", "worker")]
    return sorted(rows, key=lambda r: (0 if r["job_name"] in ("chief", "master") else 1, r["task_index"]))


def _derive_world(cluster_info, me):
    """coordinator address + (num_processes, process_id) for this node.

    ps/evaluator roles are outside the collective world (no PS on TPU —
    SURVEY.md §2.6: capability met by sync DP over ICI); they get a
    single-process world so ``initialize_distributed`` no-ops.
    """
    parts = _participants(cluster_info)
    if not parts:
        return None, 1, 0
    coord = "{}:{}".format(parts[0]["host"], parts[0]["port"])
    for i, row in enumerate(parts):
        if row["executor_id"] == me["executor_id"]:
            return coord, len(parts), i
    return None, 1, 0


def _card_peers(cluster_info, me):
    """Executor ids of the world's ranks on ``me``'s host (``me`` among
    them): the ranks whose cards :meth:`TFNodeContext.card` keeps apart."""
    host = next(r["host"] for r in cluster_info if r["executor_id"] == me["executor_id"])
    return [r["executor_id"] for r in _participants(cluster_info) if r["host"] == host]


def _nodes_on_host(ctx):
    """Nodes of the cluster whose address names this node's host (this
    one included)."""
    addrs = [a for job in (ctx.cluster_spec or {}).values() for a in job]
    try:
        host = ctx.cluster_spec[ctx.job_name][ctx.task_index].rpartition(":")[0]
    except (KeyError, IndexError, TypeError):
        return 1
    return max(1, sum(1 for a in addrs if a.rpartition(":")[0] == host))


def _child_entry(fn, tf_args, ctx, cluster_meta, error_queue_spec):
    """Entry point of the trainer child process: applies env, joins the
    distributed world, runs the user fn; failures land on the 'error' queue
    (reference wrapper_fn_background, TFSparkNode.py:355-361)."""
    publisher = None
    try:
        util.setup_logging()  # spawned interpreter: no handlers configured yet
        env = cluster_meta.get("env") or {}
        os.environ.update(env)
        # the env lane can carry a chaos plan for cross-host executors, but
        # the chaos module already ran its import-time env check in this
        # interpreter — re-check now that the lane has landed
        chaos._install_from_env()
        # adopt the cluster trace context the same way: spans below (and in
        # forked decode workers, which inherit this environ) carry the
        # driver-minted trace_id, and this child gets its own flight shard
        obs_tracing.install_from_env(
            "trainer-{}-{}".format(ctx.job_name, ctx.task_index)
        )
        # before anything touches CUDA in this (spawned) interpreter
        os.environ.update(gpu_info.visibility_env(platform=env.get(util.ENV_PLATFORM)))
        if env.get(util.ENV_PLATFORM):
            util.force_platform(env[util.ENV_PLATFORM])
        # re-connect our own IPC channel from inside the child
        addr, authkey = error_queue_spec
        ctx.mgr = TFManager.connect(addr, authkey)
        _start_heartbeat(ctx.mgr, ctx.executor_id)
        if not cluster_meta.get("obs", True):
            obs_registry.set_enabled(False)
        # the long-lived child owns this executor's obs_snapshot lane: its
        # cumulative registry is overwritten on the channel every interval
        publisher = obs_aggregate.SnapshotPublisher(ctx.mgr).start()
        # from here a preemption warning (SIGTERM, driver preempt key, or
        # the node.preempt chaos site) drains instead of dying abruptly
        _arm_preemption(ctx.mgr, ctx, publisher)
        if cluster_meta.get("jax_distributed", True):
            ctx.initialize_distributed()
        if ctx.platform == "gpu":
            import torch

            cards = torch.cuda.device_count()  # NVML: no CUDA context yet
            gpu_info.validate_against_runtime(cards)
            if cards:  # none: selecting the device raises
                # this life's executor → card map (the card stays with the
                # executor across lives, util.card_map)
                logger.info(
                    "executor %s (%s:%d): rank %d of %d on card %d of %d, coordinator %s",
                    ctx.executor_id, ctx.job_name, ctx.task_index, ctx.process_id,
                    ctx.num_processes, ctx.card(cards), cards, ctx.coordinator_address,
                )
        else:
            import torch

            # the host's trainers split its cores; each taking all of them
            # (torch's default) oversubscribes the host
            torch.set_num_threads(util.cpu_share(_nodes_on_host(ctx)))
        with obs_trace.span("node_main", job=ctx.job_name, task_index=ctx.task_index):
            fn(tf_args, ctx)
        _drain_checkpoints()
        _destroy_process_group()
        publisher.stop()  # final flush: short runs publish at least once
        ctx.mgr.set("child_status", "done")
    except BaseException as child_exc:
        tb = traceback.format_exc()
        logger.error("user main_fun failed:\n%s", tb)
        # black-box moment: an unhandled child exit stamps the trace and
        # flushes this process's flight shard so the post-mortem merge shows
        # the child's final spans even when the process is about to die
        try:
            obs_tracing.event(
                "child_failed",
                job=ctx.job_name, task_index=ctx.task_index,
                executor_id=ctx.executor_id, error=type(child_exc).__name__,
            )
            obs_flight.dump("child_failed:{}".format(type(child_exc).__name__))
        except Exception:
            pass
        # land any in-flight async checkpoint BEFORE reporting the failure:
        # the relaunched attempt resumes from the newest committed one
        _drain_checkpoints()
        try:
            if publisher is not None:
                publisher.stop()  # flush so the failed node's metrics survive
        except Exception:
            pass
        try:
            addr, authkey = error_queue_spec
            mgr = TFManager.connect(addr, authkey)
            mgr.get_queue("error").put(tb)
            mgr.set("child_status", "failed")
        except Exception:
            pass
        raise SystemExit(1)


def _destroy_process_group():
    """Leave the torch.distributed world after a clean run, if this child
    joined one, so its sockets and communicators close before the process
    exits (a failed child just exits: its peers may be mid-collective)."""
    import sys

    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


#: seconds the exiting trainer child waits for in-flight async checkpoint
#: commits to land (drain-on-exit: an accepted snapshot should become a
#: resume point, not die with the process)
CHECKPOINT_DRAIN_TIMEOUT = float(os.environ.get("TOS_CKPT_DRAIN_TIMEOUT", "120"))


def _drain_checkpoints():
    """Drain every live async checkpoint engine in this child — bounded and
    best-effort: a wedged storage backend must not turn child exit into a
    hang, and a drain failure must not mask the user fn's own outcome."""
    try:
        from tensorflowonspark_tpu_torch import ckpt

        if not ckpt.drain_all(timeout=CHECKPOINT_DRAIN_TIMEOUT):
            logger.warning(
                "async checkpoint drain timed out after %ss on child exit: %s",
                CHECKPOINT_DRAIN_TIMEOUT,
                "; ".join(ckpt.busy_descriptions()) or "engine list changed",
            )
    except Exception:
        logger.exception("async checkpoint drain failed on child exit")


#: seconds between child heartbeats on the IPC channel (the driver-side
#: monitor flags a node whose beat stops without a final child_status —
#: e.g. a SIGKILLed jax child that could post no traceback)
HEARTBEAT_INTERVAL = float(os.environ.get("TOS_HEARTBEAT_INTERVAL", "2"))


# -- preemption-aware drain ---------------------------------------------------
#
# A preemption *warning* (the platform's SIGTERM grace window, the
# ``node.preempt`` chaos site, or the driver posting ``preempt`` on the
# channel for a regrow restart) reaches the trainer child while it can still
# act. The warned path turns an abrupt kill into a clean handoff: land every
# in-flight async checkpoint, flush this node's metrics, commit a
# ``preempted`` parting status on the channel (the driver's watchdog turns
# that into a durable registry ``leave``), and exit before the kill lands.
# The recovery ladder classifies the resulting loss as a first-class
# ``preemption``: no blacklist entry, no restart-budget charge. A parked
# ps/evaluator role that its executor releases at the driver's shutdown gets
# the same SIGTERM, but the executor marks the release on the channel first
# (:data:`RELEASED_KEY`): that child commits ``released``, which the watchdog
# takes as a clean leave and not as a preemption to report. A child the
# driver's abort terminates (:data:`ABORT_KEY` is on its channel) commits
# ``aborted``: the teardown after a failure the ladder already classified,
# not a warned loss of its own.

#: channel key an executor sets before it terminates the child of a parked
#: role it is releasing
RELEASED_KEY = "released"

#: channel key the driver's :meth:`TFCluster.TFCluster.abort` posts its
#: reason under; the executor's abort watcher then terminates the child
ABORT_KEY = "abort"

_preempt_lock = threading.Lock()
_preempt = {
    "fired": False, "mgr": None, "publisher": None,
    "executor_id": None, "job_name": None, "task_index": None,
}


def _arm_preemption(mgr, ctx, publisher):
    """Hand the warned-shutdown path its channel/publisher handles and
    install the real SIGTERM handler (jax-child main thread only)."""
    with _preempt_lock:
        _preempt.update(
            mgr=mgr, publisher=publisher, executor_id=ctx.executor_id,
            job_name=ctx.job_name, task_index=ctx.task_index,
        )
    try:
        signal.signal(
            signal.SIGTERM, lambda signum, frame: _preempt_drain("sigterm")
        )
    except (ValueError, OSError):  # not the main thread / exotic platform
        pass


def _preempt_drain(source):
    """Drain and exit under a preemption warning; never returns once it wins
    the once-race (``os._exit`` — unwinding the training stack could
    overwrite the parting status with a spurious ``failed``)."""
    with _preempt_lock:
        if _preempt["fired"]:
            return  # handler/heartbeat race: first caller owns the exit
        _preempt["fired"] = True
    status = "preempted"
    if _preempt["mgr"] is not None:
        try:
            if _preempt["mgr"].get(RELEASED_KEY):
                status = "released"
            elif _preempt["mgr"].get(ABORT_KEY) is not None:
                status = "aborted"
        except Exception:
            pass
    logger.warning(
        "%s (%s): draining checkpoints before the kill lands",
        {"released": "released by the executor", "aborted": "driver abort"}.get(status, "preemption warning"),
        source,
    )
    try:
        obs_tracing.event(
            "preempt_drain", source=source,
            executor_id=_preempt["executor_id"], job=_preempt["job_name"],
            task_index=_preempt["task_index"],
        )
    except Exception:
        pass
    _drain_checkpoints()
    if _preempt["publisher"] is not None:
        try:  # flush so the drained node's metrics survive it
            _preempt["publisher"].stop()
        except Exception:
            pass
    if _preempt["mgr"] is not None:
        try:  # the parting commit the watchdog journals as a durable leave
            _preempt["mgr"].set("child_status", status)
        except Exception:
            pass
    try:
        obs_flight.dump("{}:{}".format(status, source))
    except Exception:
        pass
    os._exit(143)  # 128 + SIGTERM: the conventional warned-termination code


def _latch(path):
    """Create a chaos ``once_path`` latch file; first creator wins."""
    if not path:
        return
    try:
        with open(path, "x") as f:
            f.write(str(os.getpid()))
    except OSError:
        pass


def _start_heartbeat(mgr, executor_id=None):
    """Daemon thread bumping a counter on the channel every
    HEARTBEAT_INTERVAL; exits quietly when the channel goes away.

    ``executor_id`` scopes the ``node.kill`` / ``node.flap`` chaos sites:
    their specs carry a ``victim`` executor id and an ``after_beats`` ramp,
    so a plan can deterministically take down exactly one node mid-training
    (the recovery-ladder e2e depends on this precision — a victimless kill
    site would take out every child, since each spawned process re-installs
    the plan from the env with a fresh budget).
    """
    import threading

    def _chaos_node_fault(beat):
        # gate on the spec params BEFORE rolling the site, so non-victim
        # nodes and early beats consume neither budget nor counters
        p = chaos.plan()
        for site in ("node.kill", "node.flap", "node.preempt"):
            spec = p.sites.get(site) if p else None
            if spec is None:
                continue
            victim = spec.get("victim")
            if victim is not None and victim != executor_id:
                continue
            if beat < spec.get("after_beats", 0):
                continue
            once = spec.get("once_path")
            if once and os.path.exists(once):
                # cross-process one-shot latch: each spawned child re-installs
                # the plan with a fresh budget, so without the latch a victim
                # respawned by the recovery ladder would die on every life
                continue
            if site == "node.kill":
                if chaos.fire("node.kill"):
                    _latch(once)
                    logger.warning("chaos: node.kill — SIGKILLing executor %s child",
                                   executor_id)
                    os.kill(os.getpid(), signal.SIGKILL)
            elif site == "node.preempt":
                if chaos.fire("node.preempt"):
                    _latch(once)
                    logger.warning(
                        "chaos: node.preempt — SIGTERMing executor %s child "
                        "(warned shutdown)", executor_id,
                    )
                    os.kill(os.getpid(), signal.SIGTERM)
            else:
                if chaos.delay("node.flap"):  # paused beats: watchdog gap
                    _latch(once)

    def _beat():
        failures = 0
        # drift-free monotonic schedule with per-beat jitter: N children
        # started out of the same assembly barrier must not beat in
        # lockstep, or the aggregation tree turns the fleet's beats into
        # synchronized channel bursts (seeded by executor id so tests can
        # reproduce a schedule)
        ticker = resilience.Ticker(
            HEARTBEAT_INTERVAL, jitter=0.25, seed=executor_id
        )
        for n in ticker.ticks():
            if chaos.active:
                _chaos_node_fault(n)
            try:
                mgr.set("heartbeat", n)
                if mgr.get("preempt") is not None:
                    # the driver warned us (regrow restart / planned drain):
                    # same clean-handoff path as a platform SIGTERM
                    _preempt_drain("driver")
                failures = 0
            except Exception:
                # transient proxy hiccups must not kill the beat (the
                # watchdog would then fail a healthy node); only a channel
                # that stays dead ends the thread
                failures += 1
                if failures >= 5:
                    return

    threading.Thread(target=_beat, name="tos-heartbeat", daemon=True).start()


class _NodeLaunchTask:
    """The ``foreachPartition`` closure that boots one cluster node
    (reference ``TFSparkNode.run()._mapfn``, TFSparkNode.py:126-395)."""

    def __init__(self, fn, tf_args, cluster_meta, input_mode, log_dir=None, queues=None):
        self.fn = fn
        self.tf_args = tf_args
        self.cluster_meta = cluster_meta
        self.input_mode = input_mode
        self.log_dir = log_dir
        self.queues = tuple(queues or TFManager.CONTROL_QUEUES)

    def __call__(self, iterator):
        executor_id = None
        for i in iterator:
            executor_id = i
        if executor_id is None:
            return []
        meta = self.cluster_meta
        # PRIVATE registry: the executor process outlives this task, and a
        # relaunch on a reused executor must not double-count the global one
        # (see obs.aggregate docstring)
        reg = obs_registry.Registry(enabled=bool(meta.get("obs", True)))
        states = reg.counter(
            "node_state_transitions_total",
            help="node state-machine transitions driven by the launch task",
        )

        # Detect a live node from a previous (failed or duplicate) launch on
        # this executor: raising forces the scheduler to retry elsewhere
        # (reference TFSparkNode.py:173-179).
        prior = util.read_executor_state()
        if prior is not None:
            try:
                old = TFManager.connect(prior["address"], prior["authkey"])
                if old.get("state") in ("running", "terminating"):
                    raise RuntimeError(
                        "executor already hosts a live node for cluster {} — "
                        "forcing task retry on another executor".format(prior.get("cluster_id"))
                    )
            except RuntimeError:
                raise
            except Exception:
                pass  # stale record from a dead process: overwrite

        template = meta["cluster_template"]
        job_name, task_index = template[executor_id]
        # adopt the driver-minted trace context BEFORE the REG handshake:
        # the node_launch span below carries the cluster trace_id, and the
        # REG round-trip's driver-stamped reply seeds this host's clock
        # offset (obs.tracing.observe_clock) for the trace merger. Folding
        # the meta env lane into os.environ here also means the spawned jax
        # child and anything it forks inherit the context.
        obs_tracing.install_from_env(
            "executor{}".format(executor_id), env=meta.get("env") or {}
        )
        authkey = meta["authkey"]
        # every channel is TCP ('remote'): the driver shuts nodes down by
        # posting end-of-feed directly to each node's queues — deterministic,
        # unlike scattering shutdown tasks and hoping the scheduler spreads
        # them one-per-executor (the reference's approach, TFCluster.py:174).
        mgr = TFManager.start(authkey=authkey, queues=self.queues, mode="remote")
        # at most one live node per executor process (enforced above), so any
        # existing channel — whatever cluster/node id it served — is from a
        # finished run on this reused executor: shut it down, don't leak it
        for key in list(_live_channels):
            _live_channels.pop(key).shutdown()
        _live_channels[executor_id] = mgr  # pin the channel beyond this task
        mgr.set("state", "starting")
        states.inc()

        host = util.get_ip_address()
        port = util.find_free_port()
        is_tb_node = job_name in ("chief", "master") or (
            "chief" not in {j for j, _ in template.values()}
            and "master" not in {j for j, _ in template.values()}
            and job_name == "worker"
            and task_index == 0
        )
        tb_port = None
        if meta.get("tensorboard") and is_tb_node:
            tb_port = self._launch_tensorboard(meta.get("log_dir"))
        client = reservation.Client(meta["server_addr"])
        with obs_trace.span(
            "node_launch", registry=reg,
            executor_id=executor_id, job=job_name, task_index=task_index,
        ):
            client.register(
                {
                    "executor_id": executor_id,
                    "host": host,
                    "job_name": job_name,
                    "task_index": task_index,
                    "port": port,
                    "manager_addr": list(mgr.address),
                    "tb_port": tb_port,
                    "gpu": gpu_info.local_topology(),
                }
            )
            cluster_info = client.await_reservations(
                timeout=meta.get("reservation_timeout", 600)
            )

        # sanity: every executor id distinct (reference TFSparkNode.py:281-289)
        ids = [r["executor_id"] for r in cluster_info]
        if len(set(ids)) != len(ids):
            raise RuntimeError("duplicate executor ids in cluster: {}".format(sorted(ids)))

        self._maybe_start_aggregator(mgr, cluster_info, executor_id, authkey, meta)

        cluster_spec = {}
        for row in sorted(cluster_info, key=lambda r: (_role_rank(r["job_name"]), r["task_index"])):
            cluster_spec.setdefault(row["job_name"], []).append(
                "{}:{}".format(row["host"], row["port"])
            )
        me = {"executor_id": executor_id}
        coord, num_procs, proc_id = _derive_world(cluster_info, me)
        in_world = num_procs > 1 and meta.get("jax_distributed", False)

        util.write_executor_state(
            {
                "executor_id": executor_id,
                "cluster_id": meta["id"],
                "address": mgr.address,
                "authkey": authkey,
                "job_name": job_name,
                "task_index": task_index,
            }
        )

        ctx = TFNodeContext(
            executor_id=executor_id,
            job_name=job_name,
            task_index=task_index,
            cluster_spec=cluster_spec,
            defaultFS=meta.get("default_fs", "file://"),
            working_dir=os.getcwd(),
            mgr=None,  # child re-connects its own handle
            coordinator_address=coord,
            num_processes=num_procs if in_world else 1,
            process_id=proc_id,
            topology=gpu_info.local_topology(),
            card_peers=_card_peers(cluster_info, me) if in_world else None,
            lost=meta.get("blacklist", ()),
            cluster_meta={
                k: meta[k]
                for k in ("id", "server_addr", "input_mode", "feed_shm", "obs")
                if k in meta
            },
        )
        mgr.set("state", "running")
        states.inc()
        logger.info(
            "node %s:%d (executor %d) up; world=%s procs=%d id=%d",
            job_name, task_index, executor_id, coord, num_procs, proc_id,
        )

        # spawned, not forked: the executor process carries queue-feeder
        # threads by now, and the child gets a pristine interpreter so the
        # env vars _child_entry sets land before CUDA is first initialised
        import functools

        if (meta.get("env") or {}).get(util.ENV_PLATFORM) == "cpu":
            # a CPU trainer shares its host's cores: its OpenMP threads wait
            # passively, so a busy host slows it in proportion instead of
            # starving it (spinning teams of several processes on the same
            # cores slowed each other many times over). The runtime reads
            # this when it loads, before any of the child's code runs, so it
            # rides the environment the child is spawned with.
            os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
        child = util.spawn_process(
            functools.partial(
                _child_entry, self.fn, self.tf_args, ctx, meta, (mgr.address, authkey)
            ),
            name="trainer-node-{}-{}".format(job_name, task_index),
        )
        child.start()
        self._register_child(child)
        self._start_abort_watch(mgr, child, job_name, task_index)

        def _flush_obs():
            # exactly once per return path (accumulate merges, so twice
            # would double-count); channel failure must not fail the node
            try:
                obs_aggregate.accumulate_to_channel(mgr, reg)
            except Exception:
                pass

        if job_name in ("ps", "evaluator"):
            # park until the driver posts a shutdown message on the control
            # queue (reference ps wait loop, TFSparkNode.py:373-390)
            control = mgr.get_queue("control")
            while True:
                msg = control.get(block=True)
                control.task_done()
                if msg is None:
                    break
            # the driver's release, not a preemption (see RELEASED_KEY)
            mgr.set(RELEASED_KEY, True)
            child.terminate()
            child.join(timeout=10)
            mgr.set("state", "stopped")
            states.inc()
            _flush_obs()
        elif self.input_mode == "spark":
            # return immediately: this executor's slot is needed for feed tasks
            _flush_obs()
        else:
            # InputMode.TENSORFLOW: the task occupies the slot until training
            # finishes (reference fg-thread dispatch, TFSparkNode.py:391-395)
            child.join()
            mgr.set("state", "stopped")
            states.inc()
            _flush_obs()
            if child.exitcode != 0:
                if mgr.get(ABORT_KEY) is not None:
                    # the driver's abort watcher killed this child on
                    # purpose: returning (not raising) keeps Spark from
                    # retrying the task against a cluster being torn down
                    logger.info(
                        "node %s:%d terminated by driver abort: %s",
                        job_name, task_index, mgr.get("abort"),
                    )
                    return []
                if mgr.get("child_status") == "preempted":
                    # warned shutdown: the child drained and committed its
                    # parting status before exiting — surface a first-class
                    # preemption so the ladder skips the blacklist and the
                    # restart budget (see elastic.classify_failure)
                    raise RuntimeError(
                        "node {}:{} preempted (executor {})".format(
                            job_name, task_index, executor_id
                        )
                    )
                err = None
                try:
                    eq = mgr.get_queue("error")
                    if not eq.empty():
                        err = eq.get(block=False)
                        eq.task_done()
                except Exception:
                    pass
                raise RuntimeError(
                    "node {}:{} failed (exit {}):\n{}".format(
                        job_name, task_index, child.exitcode, err or "<no traceback captured>"
                    )
                )
        return []

    @staticmethod
    def _maybe_start_aggregator(mgr, cluster_info, executor_id, authkey, meta):
        """Start the heartbeat aggregation thread when this executor is an
        elected aggregator for the assembled cluster.

        The election (:func:`registry.plan_aggregation_tree`) is a pure
        function of ``cluster_info``, so every executor and the driver agree
        on the tree without another rendezvous round-trip. The thread is a
        daemon on the *executor* process (which outlives the launch task in
        spark mode via ``_live_channels``), publishing per-window beat
        summaries on this node's own channel; the driver's watchdog reads
        those instead of polling every member directly. Failure to start is
        non-fatal — the driver falls back to direct polls.

        Idempotent per executor process: the aggregator thread also outlives
        the launch task, so a Spark task retry (or a relaunch generation with
        a different tree) first stops the previous aggregator — otherwise two
        threads would interleave independently-numbered windows under
        ``WINDOW_KEY`` and the driver's freshness check would flap."""
        from tensorflowonspark_tpu_torch import registry as registry_mod

        try:
            with _live_aggregators_lock:
                prev = _live_aggregators.pop(executor_id, None)
            if prev is not None:
                prev.stop()
            if not registry_mod.aggregation_enabled(len(cluster_info)):
                return
            tree = registry_mod.plan_aggregation_tree(cluster_info)
            members = tree.get(executor_id)
            if not members:
                return
            rows = {r["executor_id"]: r for r in cluster_info}
            agg = registry_mod.HeartbeatAggregator(
                mgr,
                [rows[m] for m in members if m in rows],
                authkey,
                obs_enabled=bool(meta.get("obs", True)),
            )
            agg.start()
            with _live_aggregators_lock:
                _live_aggregators[executor_id] = agg
            logger.info(
                "executor %d aggregating heartbeats for members %s",
                executor_id, members,
            )
        except Exception:
            logger.exception("heartbeat aggregator failed to start; "
                             "driver will poll members directly")

    @staticmethod
    def _start_abort_watch(mgr, child, job_name, task_index):
        """Executor-side kill switch: a daemon thread that terminates the jax
        child when the driver posts an ``"abort"`` reason on this node's
        channel (:meth:`TFCluster.TFCluster.abort`).

        This is what makes failure *recovery* possible on top of failure
        *detection*: in InputMode.TENSORFLOW the launch task blocks in
        ``child.join()`` holding its executor slot, so after one node dies the
        surviving nodes' tasks would pin their executors until training ended
        naturally — and a relaunch on the same SparkContext would queue behind
        them forever. The reference stopped at detection and SystemExit
        (reference TFCluster.py:178-183); here the driver can reclaim every
        executor deterministically and relaunch (``run_with_recovery``).

        The abort flag is a dedicated kv key, NOT a ``state`` value: the
        state machine's ``"terminating"`` is written by the child to stop the
        feed plane, and an abort arriving mid-terminate must not race it.
        The watcher answers every abort — even for a child that already
        exited on its own (spark-mode tasks return immediately, so nobody
        else would confirm that node down) — and retires only when the node
        reaches ``"stopped"`` or its channel dies."""
        import threading

        def _watch():
            ticker = resilience.Backoff(base=1.0, factor=1.0, max_delay=1.0, jitter=0.0)
            for _ in ticker.attempts():
                try:
                    if mgr.get(ABORT_KEY) is not None:
                        if child.is_alive():
                            logger.warning(
                                "driver abort: terminating trainer child %s:%d", job_name, task_index
                            )
                            child.terminate()
                            child.join(timeout=10)
                            if child.is_alive() and hasattr(child, "kill"):
                                # its SIGTERM handler never ran: the main
                                # thread is blocked (a collective on a lost
                                # peer never returns to the interpreter)
                                child.kill()
                                child.join(timeout=5)
                            logger.warning(
                                "driver abort: trainer child %s:%d exited %s",
                                job_name, task_index, child.exitcode,
                            )
                        mgr.set("state", "stopped")
                        return
                    if mgr.get("state") == "stopped":
                        return  # node retired through a normal shutdown path
                except Exception:
                    return  # channel gone: node already shut down

        threading.Thread(
            target=_watch, name="tos-abort-watch-{}-{}".format(job_name, task_index), daemon=True
        ).start()

    @staticmethod
    def _register_child(proc):
        try:
            from tensorflowonspark_tpu_torch.backends import local as local_backend

            local_backend.register_child_process(proc)
        except Exception:
            pass

    def _launch_tensorboard(self, log_dir):
        """Launch a TensorBoard subprocess on this (chief) executor if the
        binary is available (reference TFSparkNode.py:206-238). Returns the
        port or None. The jax child additionally serves profiler data into
        ``log_dir`` via jax.profiler."""
        import subprocess
        import sys

        port = util.find_free_port()
        cmd = [
            sys.executable, "-m", "tensorboard.main",
            "--logdir", log_dir or os.getcwd(),
            "--host", "0.0.0.0", "--port", str(port),
        ]
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        except OSError as e:
            logger.warning("could not launch tensorboard: %s", e)
            return None
        self._register_child(_PopenAdapter(proc))
        logger.info("tensorboard listening on port %d (logdir=%s)", port, log_dir)
        return port


class _PopenAdapter:
    """Adapts subprocess.Popen to the mp.Process reaping surface the local
    backend expects (is_alive/terminate/join)."""

    def __init__(self, popen):
        self._p = popen

    def is_alive(self):
        return self._p.poll() is None

    def terminate(self):
        self._p.terminate()

    def join(self, timeout=None):
        try:
            self._p.wait(timeout=timeout)
        except Exception:
            pass


def _connect_executor_channel():
    state = util.read_executor_state()
    if state is not None and state.get("executor_id") in _live_channels:
        return state, _live_channels[state["executor_id"]]
    if state is None:
        raise RuntimeError(
            "no cluster node on this executor (missing {} in {}) — was the "
            "cluster started, and is this task on a cluster executor?".format(
                util.EXECUTOR_STATE_FILE, os.getcwd()
            )
        )
    return state, TFManager.connect(state["address"], state["authkey"])


def drain_queue(mgr, qname, max_items=100000):
    """Empty a feed queue at teardown, releasing shared-memory segments the
    consumer never materialized (a dead jax child cannot unlink them; the
    age-gated janitor is a day-scale backstop, not the primary cleanup)."""
    from tensorflowonspark_tpu_torch.shm import ShmChunk

    q = mgr.get_queue(qname)
    drained = 0
    for _ in range(max_items):
        try:
            item = q.get_nowait()
        except Exception:
            break
        if isinstance(item, ShmChunk):
            item.discard()
        q.task_done()
        drained += 1
    if drained:
        logger.info("drained %d unconsumed item(s) from %r at shutdown", drained, qname)
    return drained


def peek_error(mgr):
    """Non-destructively read a traceback from a node's error queue, or None.

    The peek-and-requeue keeps the error visible to later tasks too
    (reference trick, TFSparkNode.py:576-582)."""
    eq = mgr.get_queue("error")
    if eq.empty():
        return None
    try:
        tb = eq.get(block=False)
    except Exception:
        return None
    eq.put(tb)
    eq.task_done()
    return tb


def _raise_if_remote_error(mgr):
    tb = peek_error(mgr)
    if tb is not None:
        raise RuntimeError("error in jax child process:\n{}".format(tb))


def _chaos_trim(buf):
    """Chaos fault ``feed.truncate_chunk``: drop the tail of one train chunk
    (a torn feed message). Train-only — inference feeds keep their 1:1
    row/output contract, so this is called from the train feeder alone."""
    if chaos.fire("feed.truncate_chunk"):
        return buf[: max(1, len(buf) // 2)]
    return buf


class _TrainPartitionTask:
    """Feeds one RDD partition into the executor's input queue
    (reference ``TFSparkNode.train()._train``, TFSparkNode.py:400-467)."""

    def __init__(self, cluster_meta, qname="input", feed_timeout=600, chunk_size=None):
        self.cluster_meta = cluster_meta
        self.qname = qname
        self.feed_timeout = feed_timeout
        self.chunk_size = chunk_size or FEED_CHUNK_SIZE
        # captured at task construction (driver side) so the executor honors
        # the driver's setting regardless of its own env
        self.use_shm = FEED_SHM

    def __call__(self, iterator):
        _state, mgr = _connect_executor_channel()
        if mgr.get("state") == "terminating":
            logger.info("node is terminating; skipping partition")
            for _ in iterator:  # drain so the scheduler sees the task consumed
                pass
            return []
        # private per-task registry, accumulated onto the channel at task end
        # (see obs.aggregate docstring for the double-count rationale)
        reg = obs_registry.Registry(enabled=bool(self.cluster_meta.get("obs", True)))
        rows_c = reg.counter("feed_rows_total", help="rows fed into the input queue")
        chunks_c = reg.counter("feed_chunks_total", help="feed-plane chunk messages enqueued")
        depth_g = reg.gauge(
            "feed_queue_depth", help="unconsumed input-queue items at last sample"
        )
        q = mgr.get_queue(self.qname)
        count = 0
        buf = []
        try:
            with obs_trace.span("feed_wave", registry=reg, qname=self.qname) as sp:
                for item in iterator:
                    buf.append(item)
                    count += 1
                    if len(buf) >= self.chunk_size:
                        if chaos.active:
                            buf = _chaos_trim(buf)
                        _put_rows(q, buf, self.use_shm)
                        rows_c.inc(len(buf))
                        chunks_c.inc()
                        buf = []
                if buf:
                    if chaos.active:
                        buf = _chaos_trim(buf)
                    _put_rows(q, buf, self.use_shm)
                    rows_c.inc(len(buf))
                    chunks_c.inc()
                sp.set(rows=count)
                logger.info(
                    "fed %d items to queue %r; waiting for consumption", count, self.qname
                )
                # fine-grained poll at first (a consumer already caught up
                # finishes the wait in ~ms, which matters for many small
                # partitions), backing off so long waits don't hammer the proxy
                poll = resilience.Backoff(base=0.002, factor=2.0, max_delay=0.1, jitter=0.0)
                pending = 0
                for _ in poll.attempts(deadline=resilience.Deadline(self.feed_timeout)):
                    pending = q.unfinished()
                    depth_g.set(pending)
                    if pending <= 0:
                        break
                    _raise_if_remote_error(mgr)
                    if mgr.get("state") == "terminating":
                        break
                else:
                    raise RuntimeError(
                        "feed timeout: queue {!r} still has {} unconsumed items".format(
                            self.qname, pending
                        )
                    )
        finally:
            try:  # metrics must surface even when the wave times out
                obs_aggregate.accumulate_to_channel(mgr, reg)
            except Exception:
                pass
        _raise_if_remote_error(mgr)
        if mgr.get("state") == "terminating":
            # training said "enough" (e.g. reached target steps): tell the
            # driver so it can stop scheduling feed jobs
            # (reference TFSparkNode.py:451-464)
            try:
                reservation.Client(self.cluster_meta["server_addr"]).request_stop()
            except reservation.ReservationError:
                pass
        return []


class _InferencePartitionTask:
    """Feeds one partition and collects exactly its results
    (reference ``TFSparkNode.inference()._inference``, TFSparkNode.py:470-529).

    REQUIRES one concurrent task per executor (spark.executor.cores=1 or
    spark.task.cpus=executor cores) — the same hard invariant the reference
    held (its TFSparkNode.py:116-119). Two inference tasks interleaving on
    one executor channel could split a result chunk across collectors; the
    collector below detects the resulting over-collection and fails loudly
    rather than starving the peer task into a feed timeout."""

    def __init__(self, cluster_meta, qname_in="input", qname_out="output", feed_timeout=600, chunk_size=None):
        self.cluster_meta = cluster_meta
        self.qname_in = qname_in
        self.qname_out = qname_out
        self.feed_timeout = feed_timeout
        self.chunk_size = chunk_size or FEED_CHUNK_SIZE
        self.use_shm = FEED_SHM

    def __call__(self, iterator):
        _state, mgr = _connect_executor_channel()
        reg = obs_registry.Registry(enabled=bool(self.cluster_meta.get("obs", True)))
        rows_c = reg.counter("feed_rows_total", help="rows fed into the input queue")
        chunks_c = reg.counter("feed_chunks_total", help="feed-plane chunk messages enqueued")
        results_c = reg.counter(
            "inference_results_total", help="inference results collected back from nodes"
        )
        q = mgr.get_queue(self.qname_in)
        count = 0
        buf = []
        try:
            with obs_trace.span("inference_wave", registry=reg, qname=self.qname_in) as sp:
                for item in iterator:
                    buf.append(item)
                    count += 1
                    if len(buf) >= self.chunk_size:
                        _put_rows(q, buf, self.use_shm)
                        rows_c.inc(len(buf))
                        chunks_c.inc()
                        buf = []
                if buf:
                    _put_rows(q, buf, self.use_shm)
                    rows_c.inc(len(buf))
                    chunks_c.inc()
                q.put(EndPartition(), block=True)
                sp.set(rows=count)
                if count == 0:
                    return []
                poll = resilience.Backoff(base=0.002, factor=2.0, max_delay=0.1, jitter=0.0)
                for _ in poll.attempts(deadline=resilience.Deadline(self.feed_timeout)):
                    if q.unfinished() <= 0:
                        break
                    _raise_if_remote_error(mgr)
                else:
                    raise RuntimeError(
                        "inference feed timeout on queue {!r}".format(self.qname_in)
                    )
                from tensorflowonspark_tpu_torch.shm import ShmChunk

                out = mgr.get_queue(self.qname_out)
                results = []
                while len(results) < count:
                    item = out.get(block=True, timeout=self.feed_timeout)
                    out.task_done()
                    if isinstance(item, ShmChunk):
                        results.extend(item.rows())
                    elif isinstance(item, Chunk):
                        results.extend(item.items)
                    else:
                        results.append(item)
                results_c.inc(len(results))
        finally:
            try:
                obs_aggregate.accumulate_to_channel(mgr, reg)
            except Exception:
                pass
        if len(results) > count:
            raise RuntimeError(
                "collected {} inference results for a {}-item partition: "
                "another task is sharing this executor's channel — run "
                "inference with one concurrent task per executor "
                "(spark.executor.cores=1)".format(len(results), count)
            )
        logger.info("collected %d inference results", len(results))
        return results


class _ShutdownPartitionTask:
    """Posts end-of-feed to one worker's queues and confirms the node wound
    down (reference ``TFSparkNode.shutdown()._shutdown``, TFSparkNode.py:534-588)."""

    def __init__(self, cluster_meta, queues=("input",), grace_secs=0):
        self.cluster_meta = cluster_meta
        self.queues = tuple(queues)
        self.grace_secs = grace_secs

    def __call__(self, iterator):
        for _ in iterator:
            pass
        _state, mgr = _connect_executor_channel()
        for qname in self.queues:
            mgr.get_queue(qname).put(None, block=True)
        # give the child time to drain + export (reference grace sleep,
        # TFSparkNode.py:571-574); when we own the child handle (local
        # backend: launch ran in this very process) join it instead.
        joined = False
        try:
            from tensorflowonspark_tpu_torch.backends import local as local_backend

            for proc in local_backend._executor_children:
                proc.join(timeout=max(self.grace_secs, 60))
                joined = True
        except Exception:
            pass
        if not joined and self.grace_secs:
            time.sleep(self.grace_secs)
        _raise_if_remote_error(mgr)
        mgr.set("state", "stopped")
        # janitor: feed segments orphaned by a crashed consumer. The age gate
        # must exceed any plausible feed backlog (feed_timeout defaults to
        # 600 s), so only segments a full day old are presumed dead.
        from tensorflowonspark_tpu_torch import shm

        shm.unlink_leaked(max_age_secs=86400)
        return []


class _PreflightTask:
    """Per-executor health probe run as a short Spark task *between* cluster
    attempts (the recovery ladder's health gate, :mod:`~tensorflowonspark_tpu_torch.elastic`).

    Each partition carries one executor id. The probe checks the three
    resources a relaunch needs from this host — scratch-dir writability,
    a TCP loopback round-trip (the manager-channel transport), and
    accelerator visibility — plus the live manager channel when one survives
    from a previous attempt, and an optional picklable ``extra_probe`` hook.
    Returns one report dict per executor; a failed check is recorded as its
    error string, never raised, so one bad host cannot fail the whole gate.
    """

    def __init__(self, extra_probe=None):
        self.extra_probe = extra_probe

    def __call__(self, iterator):
        executor_id = None
        for i in iterator:
            executor_id = i
        if executor_id is None:
            return []
        checks = {}
        checks["scratch"] = self._check_scratch()
        checks["loopback"] = self._check_loopback()
        checks["devices"] = self._check_devices()
        # the local backend advertises the hosting executor's identity in
        # the process env — a mismatch means the pin was not honored and
        # this report would be attributed to the wrong host
        lane = os.environ.get("TOS_LOCAL_EXECUTOR_ID")
        if lane is not None:
            checks["pinning"] = (
                "ok" if str(executor_id) == lane
                else "partition for executor {} ran on executor {}".format(
                    executor_id, lane
                )
            )
        channel = self._check_channel(executor_id)
        if channel is not None:
            checks["channel"] = channel
        if self.extra_probe is not None:
            try:
                self.extra_probe(executor_id)
                checks["extra"] = "ok"
            except Exception as e:
                checks["extra"] = "{}: {}".format(type(e).__name__, e)
        report = {
            "executor_id": executor_id,
            "ok": all(v == "ok" for v in checks.values()),
            "checks": checks,
        }
        return [report]

    @staticmethod
    def _check_scratch():
        """Write/read/delete a probe file where node scratch state lives."""
        path = os.path.join(os.getcwd(), ".tos_preflight_{}".format(os.getpid()))
        try:
            with open(path, "w") as f:
                f.write("probe")
            with open(path) as f:
                if f.read() != "probe":
                    return "scratch readback mismatch"
            os.remove(path)
            return "ok"
        except OSError as e:
            try:
                os.remove(path)
            except OSError:
                pass
            return "{}: {}".format(type(e).__name__, e)

    @staticmethod
    def _check_loopback():
        """TCP round-trip on loopback — the manager channel's transport."""
        import socket

        try:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.bind(("127.0.0.1", 0))
            srv.listen(1)
            srv.settimeout(5.0)
            cli = socket.create_connection(srv.getsockname(), timeout=5.0)
            conn, _ = srv.accept()
            cli.sendall(b"ping")
            data = conn.recv(4)
            cli.close()
            conn.close()
            srv.close()
            return "ok" if data == b"ping" else "loopback echo mismatch"
        except OSError as e:
            return "{}: {}".format(type(e).__name__, e)

    @staticmethod
    def _check_devices():
        """Accelerator visibility without importing jax in the executor."""
        try:
            topo = gpu_info.local_topology()
            if not topo:
                return "no local topology"
            return "ok"
        except Exception as e:
            return "{}: {}".format(type(e).__name__, e)

    @staticmethod
    def _check_channel(executor_id):
        """Round-trip the live manager channel when a previous attempt left
        one on this executor; None when there is nothing to probe."""
        mgr = _live_channels.get(executor_id)
        if mgr is None:
            state = util.read_executor_state()
            if state is None or state.get("executor_id") != executor_id:
                return None
            try:
                mgr = TFManager.connect(state["address"], state["authkey"])
            except Exception as e:
                return "{}: {}".format(type(e).__name__, e)
        try:
            mgr.set("preflight", executor_id)
            if mgr.get("preflight") != executor_id:
                return "channel readback mismatch"
            return "ok"
        except Exception as e:
            return "{}: {}".format(type(e).__name__, e)


# -- public factory API (names match the reference) ---------------------------


def run(fn, tf_args, cluster_meta, input_mode, log_dir=None, queues=None):
    """Build the node-launch closure for ``nodeRDD.foreachPartition``."""
    return _NodeLaunchTask(fn, tf_args, cluster_meta, input_mode, log_dir, queues)


def train(cluster_info, cluster_meta, feed_timeout=600, qname="input"):
    del cluster_info  # reconnection goes through the executor state file
    return _TrainPartitionTask(cluster_meta, qname=qname, feed_timeout=feed_timeout)


def inference(cluster_info, cluster_meta, feed_timeout=600, qname="input", qname_out="output"):
    del cluster_info
    return _InferencePartitionTask(
        cluster_meta, qname_in=qname, qname_out=qname_out, feed_timeout=feed_timeout
    )


def shutdown(cluster_info, cluster_meta, queues=("input",), grace_secs=0):
    del cluster_info
    return _ShutdownPartitionTask(cluster_meta, queues=queues, grace_secs=grace_secs)


def preflight(extra_probe=None):
    """Build the per-executor health-probe closure for
    ``rdd.mapPartitions(...).collect()`` (see :mod:`~tensorflowonspark_tpu_torch.elastic`)."""
    return _PreflightTask(extra_probe=extra_probe)
