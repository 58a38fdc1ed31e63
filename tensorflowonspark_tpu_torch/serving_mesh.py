"""Survivable serving mesh: replica leases, routed failover, hot model swap —
the port of the JAX package's ``serving_mesh.py``.

One :class:`~tensorflowonspark_tpu_torch.serving.InferenceServer` is a single
point of failure — one SIGKILL takes down all of serving while the training
plane shrugs off executor kills. This module grows serving into a
cluster-level plane built from the same substrate as the control plane's
membership registry:

* :class:`ServingMesh` — runs N replicas (in-process threads for tests and
  single-host meshes, forked processes for crash isolation), each holding a
  TTL lease in a :class:`~tensorflowonspark_tpu_torch.registry.MembershipRegistry`.
  A monitor thread pings every replica, renews its lease on each answered
  ping, lets silent replicas expire through the registry's lease machinery,
  and relaunches them on a fresh port — ``serving_replicas_active`` dips,
  then recovers.
* :class:`ReplicaRouter` — client-side load balancer over the live leases:
  round-robin across replicas whose per-replica
  :class:`~tensorflowonspark_tpu_torch.resilience.CircuitBreaker` admits traffic,
  deadline-bounded failover (a request that hits a dead or shedding replica
  is replayed on another — prediction is stateless, so replay is safe), and
  request hedging (a primary that exceeds ``hedge_after`` seconds gets a
  duplicate sent to a second replica; first answer wins). When every live
  replica's circuit is open the router sheds with a distinct
  :class:`~tensorflowonspark_tpu_torch.serving.Overloaded` reason instead of
  hanging — mesh-wide graceful degradation.
* :class:`ModelPointer` + the per-replica swap watcher — zero-downtime
  model hot-swap. ``publish()`` exports a new generation next to the old
  ones, stamps it with a :mod:`~tensorflowonspark_tpu_torch.ckpt.manifest`
  (tmp + fsync + rename, manifest written last), then atomically flips a
  ``CURRENT`` pointer file. Each replica polls the pointer, cheap-verifies
  the new generation with ``manifest.verify()`` (a torn publish is rejected
  and counted, never a crash), loads and *warms* the new predictor off the
  request path, then swaps it in atomically while in-flight requests drain
  on the old bundle.
* :class:`MeshFrontend` — one TCP endpoint speaking the InferenceServer
  wire protocol, fanned out through a router: what
  ``python -m tensorflowonspark_tpu_torch.serving mesh`` binds.

Chaos sites (see the site table in :mod:`tensorflowonspark_tpu_torch.chaos`):
``serving.replica_kill`` SIGKILLs a live replica from the monitor loop,
``serving.router_partition`` drops the router's connection to the replica
chosen for a request, and ``serving.swap_torn`` tears the manifest of a
freshly published generation. Metrics: ``serving_replicas_active`` gauge,
``serving_failovers_total``, ``serving_hedges_total``,
``serving_swaps_total``, ``serving_swap_rejects_total``,
``serving_mesh_shed_total``, ``serving_circuit_open_total``,
``serving_replica_relaunches_total`` — all in the process-global registry,
so a driver-side mesh surfaces them through ``TFCluster.metrics()``.

**Devices and fork.** Each replica loads its bundle on the device the
``TOS_PLATFORM`` lane names (:func:`serving.platform_device`): the card
unless the lane says ``cpu``; on a one-card host every replica takes
``cuda:0``. Process mode forks, as the JAX package does, and a child forked
from a process that has set up CUDA cannot use the card: the mesh parent
only routes and monitors and must never touch CUDA, and a fork from a
parent with CUDA initialized raises instead of switching the start method.
"""

import logging
import os
import shutil
import signal
import socket
import threading
import time

from tensorflowonspark_tpu_torch import chaos, obs, resilience, serving
from tensorflowonspark_tpu_torch.ckpt import manifest
from tensorflowonspark_tpu_torch.registry import MembershipRegistry
from tensorflowonspark_tpu_torch.reservation import MessageSocket

logger = logging.getLogger(__name__)

#: generation directories are ``gen-000042``; the pointer file names one
GEN_PREFIX = "gen-"
CURRENT_NAME = "CURRENT"

_EID_PREFIX = "serving-"


def _eid(rid):
    return "{}{}".format(_EID_PREFIX, rid)


def _rid_of(eid):
    """Mesh replica id for a registry eid, or None for foreign members."""
    text = str(eid)
    if not text.startswith(_EID_PREFIX):
        return None
    try:
        return int(text[len(_EID_PREFIX):])
    except ValueError:
        return None


def is_pointer_dir(path):
    """True when ``path`` is a generation-pointer dir (has a CURRENT file)."""
    return os.path.isfile(os.path.join(path, CURRENT_NAME))


def _tear_manifest(path):
    """Truncate a just-written manifest half-way — the crash-between-write-
    and-fsync shape ``serving.swap_torn`` injects."""
    mpath = os.path.join(path, manifest.MANIFEST_NAME)
    try:
        with open(mpath, "rb") as f:
            data = f.read()
        with open(mpath, "wb") as f:
            f.write(data[: max(1, len(data) // 2)])
    except OSError:
        logger.warning("chaos: could not tear manifest under %s", path)


class ModelPointer:
    """A directory of model generations plus an atomically-updated pointer.

    Layout::

        root/
          gen-000000/   # a train.export bundle + MANIFEST.json
          gen-000001/
          CURRENT       # one line: the live generation's name

    ``publish`` follows the ckpt commit protocol: bundle files land in a
    staging dir, ``MANIFEST.json`` is written last, one ``os.rename``
    publishes the generation, and only then does ``CURRENT`` flip (its own
    tmp + fsync + rename). A crash at any point leaves either the old
    pointer or a fully-described new generation — replicas additionally
    cheap-verify before swapping, so even a torn manifest (the
    ``serving.swap_torn`` chaos shape) degrades to "keep serving the old
    model", never a crash."""

    def __init__(self, root):
        self.root = os.path.abspath(os.path.expanduser(root))
        os.makedirs(self.root, exist_ok=True)

    def generations(self):
        """Published generation names, oldest first."""
        return sorted(
            d for d in os.listdir(self.root)
            if d.startswith(GEN_PREFIX) and os.path.isdir(os.path.join(self.root, d))
        )

    def current(self):
        """``(generation_name, generation_dir)`` per the pointer, or None."""
        try:
            with open(os.path.join(self.root, CURRENT_NAME)) as f:
                name = f.read().strip()
        except OSError:
            return None
        if not name:
            return None
        return name, os.path.join(self.root, name)

    def publish(self, predict_builder, params, model_state=None, step=None):
        """Export a new generation and flip the pointer to it. Returns the
        generation dir. The ``serving.swap_torn`` chaos site tears the
        manifest *after* export but *before* the pointer flip — the torn
        generation is published and pointed at, and replicas must reject it."""
        from tensorflowonspark_tpu_torch.train import export as train_export

        gens = self.generations()
        nxt = int(gens[-1][len(GEN_PREFIX):]) + 1 if gens else 0
        name = "{}{:06d}".format(GEN_PREFIX, nxt)
        staging = os.path.join(self.root, "tmp." + name)
        if os.path.exists(staging):
            shutil.rmtree(staging)
        train_export.export_model(
            staging, predict_builder, params, model_state=model_state
        )
        return self._commit(staging, name, step=step)

    def publish_bundle(self, export_dir, step=None):
        """Adopt an already-exported bundle dir as the next generation."""
        gens = self.generations()
        nxt = int(gens[-1][len(GEN_PREFIX):]) + 1 if gens else 0
        name = "{}{:06d}".format(GEN_PREFIX, nxt)
        staging = os.path.join(self.root, "tmp." + name)
        if os.path.exists(staging):
            shutil.rmtree(staging)
        shutil.copytree(export_dir, staging)
        # a copied bundle may carry the source's manifest; re-stamp below
        try:
            os.remove(os.path.join(staging, manifest.MANIFEST_NAME))
        except OSError:
            pass
        return self._commit(staging, name, step=step)

    def _commit(self, staging, name, step=None):
        manifest.write_manifest(staging, step=step, extra={"generation": name})
        if chaos.active and chaos.fire("serving.swap_torn"):
            _tear_manifest(staging)
        final = os.path.join(self.root, name)
        os.rename(staging, final)
        self._set_current(name)
        logger.info("model pointer %s -> %s", self.root, name)
        return final

    def _set_current(self, name):
        tmp = os.path.join(self.root, CURRENT_NAME + ".tmp")
        with open(tmp, "w") as f:
            f.write(name + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, os.path.join(self.root, CURRENT_NAME))
        try:
            dirfd = os.open(self.root, os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)
        except OSError:
            pass  # pointer durability is best-effort; the rename is atomic


def _zeros_for(spec):
    """A 1-row all-zeros batch matching a recorded request signature."""
    import numpy as np

    return {
        name: np.zeros((1,) + tuple(shape), dtype=np.dtype(dtype))
        for name, dtype, shape in spec
    }


class ReplicaServer:
    """One mesh replica: an :class:`serving.InferenceServer` plus, when
    serving a :class:`ModelPointer` dir, a hot-swap watcher thread.

    The watcher polls ``CURRENT``; a new generation is cheap-verified
    (``manifest.verify`` — a torn publish increments
    ``serving_swap_rejects_total`` and the old model keeps serving), loaded
    and warmed off the request path (one zeros-batch predict shaped like the
    last real request, so the first call's set-up happens before the flip),
    then swapped in atomically. In-flight requests drain on the old
    predictor; once they are done the old predictor drops its model and
    weights, so the caching allocator can reuse their device memory."""

    def __init__(self, model, host="127.0.0.1", port=0, poll_interval=None,
                 trusted_builder=None, max_threads=None):
        self.model = os.path.abspath(os.path.expanduser(model))
        self._trusted_builder = trusted_builder
        self._poll = poll_interval if poll_interval is not None else float(
            os.environ.get("TOS_SERVING_SWAP_POLL_SECS", "0.5")
        )
        self._pointer = None
        self._generation = None
        bundle = self.model
        if is_pointer_dir(self.model):
            self._pointer = ModelPointer(self.model)
            cur = self._pointer.current()
            if cur is None:
                raise FileNotFoundError(
                    "pointer dir {} has no published generation".format(self.model)
                )
            self._generation, bundle = cur
        self._server = serving.InferenceServer(
            bundle, host=host, port=port, max_threads=max_threads,
            trusted_builder=trusted_builder,
        )
        self._rejected = set()
        self._stop_evt = threading.Event()
        self._watcher = None
        self._lock = threading.Lock()
        self._swaps_c = obs.counter(
            "serving_swaps_total", help="zero-downtime model hot-swaps completed"
        )
        self._rejects_c = obs.counter(
            "serving_swap_rejects_total",
            help="published model generations rejected by manifest cheap-verify",
        )

    @property
    def address(self):
        return self._server.address

    def generation(self):
        """Name of the generation currently serving (None for plain bundles)."""
        with self._lock:
            return self._generation

    def start(self):
        addr = self._server.start()
        if self._pointer is not None:
            self._watcher = threading.Thread(
                target=self._watch, name="tos-swap-watch", daemon=True
            )
            self._watcher.start()
        return addr

    def stop(self):
        self._stop_evt.set()
        if self._watcher is not None:
            self._watcher.join(timeout=10)
        self._server.stop()

    def kill(self):
        """SIGKILL-shaped death for chaos: sockets close abruptly, nothing
        drains. :meth:`stop` can still be called later to reap threads."""
        self._stop_evt.set()
        self._server.kill()

    # -- hot swap ------------------------------------------------------------

    def _watch(self):
        # sleeps on the stop event: stop() joins at once, not after a poll
        ticker = resilience.Ticker(self._poll, jitter=0.25, sleep=self._stop_evt.wait)
        for _ in ticker.ticks():
            if self._stop_evt.is_set():
                return
            try:
                self.check_swap()
            except Exception:
                # the watcher must never take the replica down with it
                logger.exception("swap watcher: poll failed; will retry")

    def check_swap(self):
        """One watcher poll step (public so tests can drive it
        deterministically). Returns True when a swap happened."""
        if self._pointer is None:
            return False
        cur = self._pointer.current()
        if cur is None:
            return False
        gen, gen_dir = cur
        with self._lock:
            if gen == self._generation or gen in self._rejected:
                return False
        ok, reason = manifest.verify(gen_dir)
        if not ok:
            with self._lock:
                self._rejected.add(gen)
            self._rejects_c.inc()
            logger.warning(
                "replica %s: rejected generation %s (%s); old model keeps serving",
                self.address, gen, reason,
            )
            return False
        predict_fn, params, model_state, bound = serving.load_bundle(
            gen_dir, trusted_builder=self._trusted_builder
        )
        new_pred = serving._Predictor(predict_fn, params, model_state, device=bound)
        del predict_fn, params, model_state  # the new predictor holds them
        warm = self._server.warm_spec()
        if warm:
            try:
                new_pred.submit(_zeros_for(warm))
            except Exception:
                logger.exception("swap warm-up predict failed; flipping anyway")
        old = self._server.swap_predictor(new_pred, export_dir=gen_dir)
        with self._lock:
            self._generation = gen
        self._swaps_c.inc()
        logger.info("replica %s: hot-swapped to %s", self.address, gen)
        # in-flight requests already dispatched keep draining on the old
        # predictor; stop() joins once they are done, and the old
        # predictor's thread lets go of its model and weights as it exits
        old.stop()
        return True


def _replica_child_main(model, host, conn, poll_interval, trusted_builder):
    """Forked-process replica entry point: serve, report the bound address
    through the pipe, then wait for SIGTERM."""
    # the replica inherits the mesh's trace context through os.environ at
    # spawn; adopt it under a replica proc label so its spans land in a
    # shard of their own (no-op when tracing is inert)
    from tensorflowonspark_tpu_torch.obs import tracing as obs_tracing

    obs_tracing.install_from_env("serving-replica")
    # GNU OpenMP is not fork-safe: a child forked from a parent whose
    # intra-op pool is up hangs in its first parallel CPU op. The replica
    # runs torch's CPU ops on its own thread (its model runs on the card
    # unless the platform lane says cpu)
    import torch

    torch.set_num_threads(1)
    stop_evt = threading.Event()

    def _on_term(_signum, _frame):
        stop_evt.set()

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:
        pass  # non-main-thread start (tests): rely on SIGKILL cleanup
    try:
        replica = ReplicaServer(
            model, host=host or "127.0.0.1", port=0,
            poll_interval=poll_interval, trusted_builder=trusted_builder,
        )
        addr = replica.start()
    except Exception as e:
        try:
            conn.send(("error", "{}: {}".format(type(e).__name__, e)))
        finally:
            conn.close()
        return
    conn.send(("ok", list(addr)))
    conn.close()
    stop_evt.wait()
    replica.stop()


class _Replica:
    """Driver-side handle for one replica slot."""

    __slots__ = ("rid", "address", "server", "proc", "alive", "dead_seen", "misses")

    def __init__(self, rid):
        self.rid = rid
        self.address = None
        self.server = None   # thread mode: the in-process ReplicaServer
        self.proc = None     # process mode: the forked child
        self.alive = False
        self.dead_seen = None  # monitor tick that observed the death
        self.misses = 0        # consecutive failed pings


class ServingMesh:
    """N serving replicas held together by registry leases and a monitor.

    ``mode="thread"`` runs replicas in-process (fast, shares the obs
    registry — unit tests and single-host meshes); ``mode="process"`` forks
    one child per replica so a SIGKILL is a real process death. The monitor
    thread pings each replica every ``monitor_interval`` seconds; an
    answered ping renews the replica's lease (the ping counter is the beat,
    so renewals follow the registry's advancing-beat contract), a silent
    replica expires through ``expire_stale()`` and is relaunched on the
    next tick — ``serving_replicas_active`` dips, then recovers."""

    def __init__(self, model, replicas=3, mode="thread", registry=None,
                 lease_ttl=None, host="127.0.0.1", monitor_interval=None,
                 restart=True, swap_poll=None, trusted_builder=None,
                 spawn_timeout=60.0):
        if mode not in ("thread", "process"):
            raise ValueError("mode must be 'thread' or 'process'")
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        self.model = os.path.abspath(os.path.expanduser(model))
        self.replicas = replicas
        self.mode = mode
        self._host = host or "127.0.0.1"
        ttl = lease_ttl if lease_ttl is not None else float(
            os.environ.get("TOS_SERVING_LEASE_TTL", "10")
        )
        self.registry = registry if registry is not None else MembershipRegistry(ttl=ttl)
        self._interval = monitor_interval if monitor_interval is not None else float(
            os.environ.get("TOS_SERVING_MONITOR_SECS", "1.0")
        )
        self._ping_timeout = max(0.2, min(2.0, self._interval))
        self._restart = restart
        self._swap_poll = swap_poll
        self._trusted_builder = trusted_builder
        self._spawn_timeout = spawn_timeout
        self._lock = threading.Lock()
        self._replicas = {}
        self._beats = {}
        self._stop_evt = threading.Event()
        self._monitor = None
        self._started = False
        self._active_g = obs.gauge(
            "serving_replicas_active", help="serving replicas holding a live mesh lease"
        )
        self._relaunch_c = obs.counter(
            "serving_replica_relaunches_total",
            help="mesh replicas relaunched after their lease expired",
        )

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        """Spawn every replica, grant leases, start the monitor. Returns
        ``{rid: (host, port)}``."""
        with self._lock:
            if self._started:
                raise RuntimeError("mesh already started")
            self._started = True
        for rid in range(self.replicas):
            rec = _Replica(rid)
            with self._lock:
                self._replicas[rid] = rec
            self._spawn_into(rec)
            self.registry.join(_eid(rid), job_name="serving", task_index=rid)
        self._publish_active()
        self._monitor = threading.Thread(
            target=self._run_monitor, name="tos-mesh-monitor", daemon=True
        )
        self._monitor.start()
        return self.endpoints()

    def stop(self):
        self._stop_evt.set()
        if self._monitor is not None:
            self._monitor.join(timeout=max(10.0, self._interval * 4))
        with self._lock:
            recs = list(self._replicas.values())
        for rec in recs:
            self._reap(rec)
            self.registry.leave(_eid(rec.rid), reason="mesh stopped")
        self._publish_active()

    def endpoints(self):
        """``{rid: (host, port)}`` for replicas believed alive — the feed
        for :class:`ReplicaRouter`; refreshed on every routed request."""
        with self._lock:
            return {
                rec.rid: rec.address
                for rec in self._replicas.values()
                if rec.alive and rec.address is not None
            }

    def router(self, **kwargs):
        """A :class:`ReplicaRouter` bound to this mesh's live-endpoint view."""
        return ReplicaRouter(self.endpoints, **kwargs)

    def kill_replica(self, rid=None):
        """Hard-kill one live replica (SIGKILL in process mode; abrupt
        socket death in thread mode). The death is *discovered* — failed
        pings, then lease expiry — exactly like an unplanned crash. Returns
        the victim rid, or None when nothing is alive."""
        with self._lock:
            live = sorted(r for r, rec in self._replicas.items() if rec.alive)
            if not live:
                return None
            victim = rid if rid in live else live[0]
            rec = self._replicas[victim]
            proc, server = rec.proc, rec.server
        if proc is not None:
            try:
                os.kill(proc.pid, signal.SIGKILL)
            except OSError:
                pass
        elif server is not None:
            server.kill()
        logger.warning("mesh: hard-killed replica %s", victim)
        return victim

    # -- internals -----------------------------------------------------------

    def _spawn_into(self, rec):
        if self.mode == "thread":
            server = ReplicaServer(
                self.model, host=self._host, port=0,
                poll_interval=self._swap_poll,
                trusted_builder=self._trusted_builder,
            )
            addr = server.start()
            with self._lock:
                rec.server = server
                rec.proc = None
                rec.address = (addr[0] or "127.0.0.1", addr[1])
                rec.alive = True
                rec.dead_seen = None
                rec.misses = 0
            return
        import multiprocessing

        import torch

        if torch.cuda.is_initialized():
            raise RuntimeError(
                "serving mesh: CUDA is initialized in this process, and a replica "
                "forked from it cannot use the card; start the process-mode mesh "
                "from a process that has not touched CUDA (the mesh parent only "
                "routes and monitors; each replica sets up its own device)"
            )
        ctx = multiprocessing.get_context("fork")
        parent, child = ctx.Pipe()
        proc = ctx.Process(
            target=_replica_child_main,
            args=(self.model, self._host, child, self._swap_poll, self._trusted_builder),
            name="tos-mesh-replica-{}".format(rec.rid),
            daemon=True,
        )
        proc.start()
        child.close()
        try:
            if not parent.poll(self._spawn_timeout):
                raise RuntimeError(
                    "replica {} did not report an address within {:.0f}s".format(
                        rec.rid, self._spawn_timeout
                    )
                )
            status, payload = parent.recv()
        except (EOFError, OSError) as e:
            proc.terminate()
            raise RuntimeError("replica {} died during spawn: {}".format(rec.rid, e))
        finally:
            parent.close()
        if status != "ok":
            proc.terminate()
            raise RuntimeError("replica {} failed to start: {}".format(rec.rid, payload))
        with self._lock:
            rec.server = None
            rec.proc = proc
            rec.address = (payload[0] or "127.0.0.1", int(payload[1]))
            rec.alive = True
            rec.dead_seen = None
            rec.misses = 0

    def _reap(self, rec):
        """Release a dead (or stopping) replica's resources; idempotent."""
        with self._lock:
            proc, server = rec.proc, rec.server
            rec.proc = None
            rec.server = None
            rec.alive = False
        if proc is not None:
            try:
                proc.terminate()
            except (OSError, ValueError):
                pass
            proc.join(timeout=5)
            if proc.is_alive():
                try:
                    proc.kill()
                except (OSError, ValueError):
                    pass
                proc.join(timeout=5)
        if server is not None:
            try:
                server.stop()
            except Exception:
                logger.exception("mesh: error reaping replica %s", rec.rid)

    def _run_monitor(self):
        ticker = resilience.Ticker(self._interval, jitter=0.1, sleep=self._stop_evt.wait)
        for tick_no in ticker.ticks():
            if self._stop_evt.is_set():
                return
            try:
                self._tick(tick_no)
            except Exception:
                logger.exception("mesh monitor tick failed")

    def _tick(self, tick_no):
        if chaos.active:
            spec = chaos.fire("serving.replica_kill")
            if spec is not None:
                self.kill_replica(spec.get("victim"))
        # 1. relaunch replicas whose death was observed on an EARLIER tick —
        #    deferring one tick keeps the serving_replicas_active dip
        #    observable instead of folding expiry+relaunch into one instant
        if self._restart:
            with self._lock:
                to_respawn = [
                    rec for rec in self._replicas.values()
                    if not rec.alive and rec.dead_seen is not None
                    and tick_no > rec.dead_seen
                ]
            for rec in to_respawn:
                try:
                    self._respawn(rec)
                except Exception:
                    logger.exception("mesh: relaunch of replica %s failed", rec.rid)
        # 2. ping live replicas; every answered ping advances the beat and
        #    renews the lease
        with self._lock:
            live = [
                (rec.rid, rec.address) for rec in self._replicas.values()
                if rec.alive and rec.address is not None
            ]
        for rid, addr in live:
            if self._ping(addr):
                beat = self._beats.get(rid, 0) + 1
                self._beats[rid] = beat
                self.registry.renew(_eid(rid), beat=beat)
                with self._lock:
                    rec = self._replicas.get(rid)
                    if rec is not None:
                        rec.misses = 0
            else:
                with self._lock:
                    rec = self._replicas.get(rid)
                    if rec is None or not rec.alive:
                        continue
                    rec.misses += 1
                    # a replica that died before its FIRST beat has an
                    # expiry-exempt lease (beat is None): declare it after
                    # three straight misses so the slot still relaunches
                    declare = rec.misses >= 3 and self._beats.get(rid, 0) == 0
                    if declare:
                        rec.alive = False
                        rec.dead_seen = tick_no
                if declare:
                    logger.warning(
                        "mesh: replica %s never answered a ping; relaunching", rid
                    )
        # 3. leases that stopped renewing expire; their replicas are marked
        #    dead and relaunched on the next tick
        for eid, age in self.registry.expire_stale():
            rid = _rid_of(eid)
            if rid is None:
                continue  # foreign (training) member on a shared registry
            with self._lock:
                rec = self._replicas.get(rid)
                if rec is None or not rec.alive:
                    continue
                rec.alive = False
                rec.dead_seen = tick_no
            logger.warning(
                "mesh: replica %s lease expired after %.1fs without a ping", rid, age
            )
        self._publish_active()

    def _respawn(self, rec):
        self._reap(rec)
        self._spawn_into(rec)
        self.registry.join(_eid(rec.rid), job_name="serving", task_index=rec.rid)
        self._relaunch_c.inc()
        logger.info("mesh: relaunched replica %s at %s", rec.rid, rec.address)
        self._publish_active()

    def _ping(self, addr):
        try:
            with socket.create_connection(addr, timeout=self._ping_timeout) as sock:
                sock.settimeout(self._ping_timeout)
                msock = MessageSocket(sock)
                msock.send({"type": "ping"})
                reply = msock.recv()
                return bool(reply) and reply.get("type") == "pong"
        except (OSError, ValueError):
            return False

    def _publish_active(self):
        with self._lock:
            eids = {_eid(rid) for rid in self._replicas}
        members = self.registry.members()
        n = sum(
            1 for eid in eids if members.get(eid, {}).get("state") == "live"
        )
        self._active_g.set(n)


class ReplicaRouter:
    """Client-side load balancer over a mesh's live replicas.

    ``endpoints`` is a ``{rid: (host, port)}`` mapping or a callable
    returning one (a live view like :meth:`ServingMesh.endpoints`). Each
    replica gets its own :class:`~tensorflowonspark_tpu_torch.resilience.
    CircuitBreaker` and a small connection pool; a replica whose address
    changes (relaunch) gets a fresh breaker and pool.

    Request path: round-robin over circuit-admitted replicas; a replica
    failure (``OSError`` / ``Overloaded``) records on its breaker, counts a
    failover, and re-routes — all attempts share one
    :class:`~tensorflowonspark_tpu_torch.resilience.Deadline`. With
    ``hedge_after > 0`` a primary that has not answered within the budget
    gets a duplicate request on a second replica; first answer wins
    (prediction is stateless, so duplicates are safe). When every live
    replica's circuit is open, the request is shed *immediately* with a
    distinct ``Overloaded`` reason — graceful mesh-wide degradation instead
    of a hang."""

    def __init__(self, endpoints, deadline=None, hedge_after=None,
                 request_timeout=None, breaker_threshold=None,
                 breaker_reset=None, backoff=None, pool_size=8):
        self._endpoints_fn = endpoints if callable(endpoints) else (
            lambda snapshot=dict(endpoints): dict(snapshot)
        )
        self.deadline = deadline if deadline is not None else float(
            os.environ.get("TOS_SERVING_ROUTE_DEADLINE_SECS", "30")
        )
        self.hedge_after = hedge_after if hedge_after is not None else (
            float(os.environ.get("TOS_SERVING_HEDGE_MS", "0")) / 1000.0
        )
        self.request_timeout = request_timeout if request_timeout is not None else float(
            os.environ.get("TOS_SERVING_ROUTE_TIMEOUT_SECS", "30")
        )
        self._threshold = breaker_threshold or int(
            os.environ.get("TOS_SERVING_BREAKER_FAILURES", "3")
        )
        self._reset = breaker_reset if breaker_reset is not None else float(
            os.environ.get("TOS_SERVING_BREAKER_RESET_SECS", "5")
        )
        self._backoff = backoff if backoff is not None else resilience.Backoff(
            base=0.05, factor=2.0, max_delay=0.5, jitter=0.5
        )
        self._pool_size = pool_size
        self._lock = threading.Lock()
        self._rr = 0
        self._breakers = {}
        self._addrs = {}
        self._pools = {}
        self._executor = None
        self._failover_c = obs.counter(
            "serving_failovers_total",
            help="requests re-routed to another replica after a failure",
        )
        self._hedges_c = obs.counter(
            "serving_hedges_total",
            help="hedged duplicate requests sent to a second replica",
        )
        self._shed_c = obs.counter(
            "serving_mesh_shed_total",
            help="requests shed mesh-wide: no routable replica",
        )
        self._circuit_c = obs.counter(
            "serving_circuit_open_total",
            help="per-replica circuit-breaker trips observed by the mesh router",
        )

    # -- public request surface ----------------------------------------------

    def predict(self, **inputs):
        """JSON-lane predict with failover/hedging; returns dict of lists."""
        return self._request("json", inputs)

    def predict_binary(self, **inputs):
        """Binary-lane predict: numpy arrays in, numpy arrays out."""
        return self._request("binary", inputs)

    def close(self):
        with self._lock:
            clients = [c for pool in self._pools.values() for c in pool]
            self._pools = {}
            executor = self._executor
            self._executor = None
        for client in clients:
            try:
                client.close()
            except Exception:
                pass
        if executor is not None:
            executor.shutdown(wait=False)

    # -- routing core ----------------------------------------------------------

    def _request(self, kind, payload):
        # one span per routed client request: failovers/hedges happen inside
        # it, so a merged timeline shows routing latency per request with
        # the cluster trace_id the mesh process inherited at spawn
        with obs.span("serving_route", kind=kind):
            return self._route(kind, payload)

    def _route(self, kind, payload):
        deadline = resilience.Deadline(self.deadline)
        started = time.monotonic()
        last_err = None
        tried = set()
        routed_once = False
        for _ in self._backoff.attempts(deadline):
            eps = self._refresh()
            if not eps:
                self._shed_c.inc()
                raise serving.Overloaded(
                    "Overloaded: mesh has no live replicas; request shed"
                )
            cycle_tried = set()
            attempted_this_cycle = False
            while True:
                rid = self._pick(eps, exclude=cycle_tried)
                if rid is None:
                    break
                attempted_this_cycle = True
                cycle_tried.add(rid)
                tried.add(rid)
                if routed_once:
                    self._failover_c.inc()
                routed_once = True
                try:
                    if self.hedge_after and self.hedge_after > 0:
                        return self._hedged(rid, eps, cycle_tried, kind, payload, deadline)
                    return self._call_replica(rid, kind, payload)
                except (OSError, serving.Overloaded) as e:
                    last_err = e
                    if deadline.expired():
                        raise self._final_error(tried, started, last_err) from last_err
            if not attempted_this_cycle:
                # every live replica's circuit is open: shed, don't hang
                self._shed_c.inc()
                raise serving.Overloaded(
                    "Overloaded: all {} replica circuits open; mesh shedding "
                    "requests".format(len(eps))
                )
        raise self._final_error(tried, started, last_err) from last_err

    def _hedged(self, rid, eps, exclude, kind, payload, deadline):
        from concurrent.futures import FIRST_COMPLETED, wait

        pool = self._hedge_executor()
        pending = {pool.submit(self._call_replica, rid, kind, payload)}
        hedged = False
        last = None
        while pending:
            timeout = deadline.remaining() if hedged else deadline.clamp(self.hedge_after)
            done, pending = wait(pending, timeout=timeout, return_when=FIRST_COMPLETED)
            if not done:
                if not hedged:
                    hedged = True
                    alt = self._pick(eps, exclude=exclude)
                    if alt is not None:
                        exclude.add(alt)
                        self._hedges_c.inc()
                        pending = set(pending)
                        pending.add(pool.submit(self._call_replica, alt, kind, payload))
                    continue
                # deadline spent with calls still in flight: surface as a
                # transient so the outer loop raises the named final error
                raise ConnectionError(
                    "hedged request still in flight at the routing deadline"
                )
            for fut in done:
                err = fut.exception()
                if err is None:
                    # abandoned sibling attempts finish in the background;
                    # _call_replica already returned their clients/breakers
                    return fut.result()
                last = err
                if not isinstance(err, (OSError, serving.Overloaded)):
                    raise err
        raise last

    def _call_replica(self, rid, kind, payload):
        try:
            out = self._attempt(rid, kind, payload)
        except (OSError, serving.Overloaded):
            self._record_failure(rid)
            raise
        self._record_success(rid)
        return out

    def _attempt(self, rid, kind, payload):
        if chaos.active and chaos.fire("serving.router_partition"):
            self._drop_pool(rid)
            raise ConnectionResetError(
                "chaos: router partitioned from replica {}".format(rid)
            )
        client = self._borrow(rid)
        try:
            if kind == "binary":
                out = client.predict_binary(**payload)
            else:
                out = client.predict(**payload)
        except BaseException:
            try:
                client.close()
            except Exception:
                pass
            raise
        self._return(rid, client)
        return out

    def _pick(self, eps, exclude=()):
        order = sorted(eps)
        if not order:
            return None
        with self._lock:
            start = self._rr
            self._rr += 1
        n = len(order)
        for i in range(n):
            rid = order[(start + i) % n]
            if rid in exclude:
                continue
            with self._lock:
                breaker = self._breakers.get(rid)
            if breaker is None or breaker.allow():
                return rid
        return None

    def _refresh(self):
        """Sync breakers/pools with the current endpoint view; returns it."""
        eps = dict(self._endpoints_fn() or {})
        stale = []
        with self._lock:
            for rid, addr in eps.items():
                addr = (addr[0], int(addr[1]))
                if self._addrs.get(rid) != addr:
                    # new or relaunched replica: fresh breaker, fresh pool
                    self._addrs[rid] = addr
                    self._breakers[rid] = resilience.CircuitBreaker(
                        failure_threshold=self._threshold,
                        reset_timeout=self._reset,
                        name="serving-replica-{}".format(rid),
                    )
                    stale.extend(self._pools.pop(rid, []))
            view = {rid: self._addrs[rid] for rid in eps}
        for client in stale:
            try:
                client.close()
            except Exception:
                pass
        return view

    def _record_success(self, rid):
        with self._lock:
            breaker = self._breakers.get(rid)
        if breaker is not None:
            breaker.record_success()

    def _record_failure(self, rid):
        with self._lock:
            breaker = self._breakers.get(rid)
        if breaker is None:
            return
        before = breaker.state
        breaker.record_failure()
        if before != resilience.OPEN and breaker.state == resilience.OPEN:
            self._circuit_c.inc()

    def _borrow(self, rid):
        with self._lock:
            pool = self._pools.setdefault(rid, [])
            client = pool.pop() if pool else None
            addr = self._addrs.get(rid)
        if client is not None:
            return client
        if addr is None:
            raise ConnectionError("replica {} has no live endpoint".format(rid))
        return serving.InferenceClient(
            addr, timeout=self.request_timeout,
            retry=resilience.RetryPolicy(max_attempts=1),
        )

    def _return(self, rid, client):
        with self._lock:
            pool = self._pools.setdefault(rid, [])
            if len(pool) < self._pool_size:
                pool.append(client)
                return
        client.close()

    def _drop_pool(self, rid):
        with self._lock:
            clients = self._pools.pop(rid, [])
        for client in clients:
            try:
                client.close()
            except Exception:
                pass

    def _hedge_executor(self):
        with self._lock:
            if self._executor is None:
                from concurrent.futures import ThreadPoolExecutor

                self._executor = ThreadPoolExecutor(
                    max_workers=16, thread_name_prefix="tos-mesh-hedge"
                )
            return self._executor

    def _final_error(self, tried, started, last_err):
        elapsed = time.monotonic() - started
        return ConnectionError(
            "mesh: request failed across {} replica(s) {} after {:.1f}s of a "
            "{:.0f}s budget: {}".format(
                len(tried), sorted(tried), elapsed, self.deadline,
                last_err if last_err is not None else "no replica available",
            )
        )


class MeshFrontend(serving.ProtocolServer):
    """One TCP endpoint speaking the InferenceServer wire protocol, fanned
    out through a :class:`ReplicaRouter` — clients that only know
    ``HOST:PORT`` (the JVM client, ``infer --server``) get mesh failover
    without learning the registry. Requests cross to replicas on the binary
    tensor lane regardless of the lane the client used."""

    def __init__(self, router, host="", port=0, max_threads=None):
        self.router = router
        serving.ProtocolServer.__init__(
            self, host=host, port=port, max_threads=max_threads,
            name="tos-mesh-front",
        )

    def _submit(self, arrays):
        return self.router.predict_binary(**arrays)

    def _info(self):
        return {"type": "info", "mesh": True, "ready": True}
