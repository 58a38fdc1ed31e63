"""Multiprocess decode plane: GIL-free record decode into shared-memory slabs.

The input path's parse stage (PIL decode + augmentation,
:mod:`~tensorflowonspark_tpu_torch.data.imagenet`) ran on a GIL-bound
``ThreadPoolExecutor`` — every bench round since r03 showed training
input-path-limited with parse as the dominant stall. This module takes the
decode off the GIL the way production input stacks do (tf.data service's
parallel host pipelines, NVIDIA DALI's process-isolated decoders): a pool
of worker *processes* decode records and write the pixels **directly into
preallocated shared-memory batch slabs**
(:class:`~tensorflowonspark_tpu_torch.shm.SlabSegment`), so the producer thread
in :class:`~tensorflowonspark_tpu_torch.data.ImagePipeline` assembles
device-ready ``[B,H,W,C]`` batches as zero-copy views and the recycle pool
becomes a cross-process slab free list.

The pieces:

* :class:`DecodePlane` — worker lifecycle (fork-spawned before the
  pipeline's threads start, respawn-on-death, clean drain on teardown),
  the slab pool (:meth:`DecodePlane.new_slab` mints pooled segments; the
  loader's free queue circulates the views), and the slot lease protocol:
  one *round* leases ``(seq, slab, slot, record bytes)`` tasks to workers
  over dedicated duplex pipes and collects ``(seq, slot, label | error)``
  acks. Each worker owns its own pipe — there is no cross-worker queue
  lock a SIGKILL could strand — so a death surfaces as EOF on that pipe
  and exactly its un-acked slots are re-leased. Duplicate work is harmless:
  ``parse_fn`` is deterministic per record (the imagenet/cifar fns key
  their augmentation RNG to the record bytes), so a re-decoded slot is
  written with identical bytes, and acks are deduped by slot.
* :class:`DecodeAutotuner` — self-sizes the worker count from the same
  stall counters operators read (``data_producer_parse_seconds_total`` vs
  ``data_consumer_wait_seconds_total``), with the
  :class:`~tensorflowonspark_tpu_torch.data.autotune.FeedAutotuner` hysteresis
  discipline: grow immediately when the consumer starves on a
  parse-dominated producer, shrink only after ``down_patience``
  consecutive idle intervals.
* :func:`available` / :func:`resolve_workers` — the fallback contract:
  ``decode_workers=0`` (or a platform without fork /
  ``multiprocessing.shared_memory``) keeps today's thread pool, and the
  delivered batch stream is byte-identical across thread and process
  modes (pinned by tests/test_loader_pipeline.py).

``parse_fn`` contract: workers are **forked**, so the function (and
anything its closure captures) must be fork-inheritable and must not
depend on parent-thread state — importable module-level factories like
:func:`~tensorflowonspark_tpu_torch.data.imagenet.make_parse_fn` qualify. The
task/ack framing itself stays picklable (record bytes in, labels or error
strings out); decoded-cache writes flow back through the slab, never
through pickle.

Observability (merged into ``TFCluster.metrics()``):

==================================  =======================================
metric                              meaning
==================================  =======================================
``decode_workers``                  worker processes currently in the pool
``decode_worker_restarts_total``    workers respawned after dying mid-round
``decode_slab_bytes``               bytes resident in the slab pool
``decode_slab_wait_seconds_total``  producer waits on an empty slab free list
``decode_native_total``             records decoded by the native JPEG path
==================================  =======================================

The ``data.decode_kill`` chaos site SIGKILLs one worker mid-round
(parent-side roll, so the seeded schedule is thread-timing independent and
the fault counter lands in the process whose registry reaches the cluster
merge); the lease protocol must respawn and re-lease with no lost or
duplicated rows — exercised at cluster level by tests/test_chaos_cluster.py.
"""

import logging
import os
import signal
import time

import numpy as np

from tensorflowonspark_tpu_torch import chaos, obs
from tensorflowonspark_tpu_torch.control import Controller, DeltaTicker, StallRule
from tensorflowonspark_tpu_torch.shm import SlabSegment

logger = logging.getLogger(__name__)

#: how long one ack wait may block before the round re-checks the stop flag
#: (worker deaths need no poll — they surface as EOF on the dead pipe)
ACK_POLL_SECONDS = 0.2


class Stopped(Exception):
    """The consumer departed mid-round; unwind the caller quietly (the
    loader translates this into its own teardown exception)."""


class DecodeWorkerError(RuntimeError):
    """A record failed to parse inside a worker process. Carries the
    worker-side exception as text — the original object cannot cross the
    process boundary reliably, but the budget/absorb semantics only need
    the message."""


def available():
    """True when the process decode plane can run here: a POSIX fork start
    method and a usable ``multiprocessing.shared_memory``."""
    try:
        from multiprocessing import shared_memory  # noqa: F401
    except ImportError:
        return False
    import multiprocessing

    return "fork" in multiprocessing.get_all_start_methods()


def resolve_workers(decode_workers):
    """Normalize the ``decode_workers`` knob: ``None`` reads
    ``TOS_DECODE_WORKERS`` (default 0 = thread pool), ``"auto"`` self-sizes
    (start at half the cores, let :class:`DecodeAutotuner` move it),
    anything else is a fixed count. Returns ``(workers, autotune)``."""
    if decode_workers is None:
        decode_workers = os.environ.get("TOS_DECODE_WORKERS", "0")
    if isinstance(decode_workers, str) and decode_workers.strip().lower() == "auto":
        return max(1, (os.cpu_count() or 1) // 2), True
    return max(0, int(decode_workers)), False


def _worker_main(conn, parse_fn, inherited=()):
    """Worker-process loop: lease tasks off the dedicated pipe, decode into
    slab slots, ack on the same pipe. ``inherited`` are the parent's ends of
    this worker's pipe and of the earlier workers', which the fork copied:
    closed at once, so that a worker sees EOF as soon as the parent closes
    its end (else teardown waits out ``close``'s deadline and kills).

    Every failure mode acks — an unacked slot would stall the round until
    the parent re-leases it — so parse errors travel back as
    ``(seq, slot, False, text)`` and only a torn pipe (parent gone or
    retiring this worker) ends the loop.
    """
    # the parent's SIGINT belongs to the training process; workers die by
    # pipe EOF (retire/teardown) or SIGKILL (crash/chaos) only
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    for other in inherited:
        other.close()
    # fork carries the parent's trace context in os.environ: adopt it under
    # this worker's own proc label so the flight recorder opens a fresh
    # shard (never interleaving the parent's), and stamp the fork on the
    # timeline. No-ops entirely when no trace is active.
    from tensorflowonspark_tpu_torch.obs import tracing as obs_tracing

    obs_tracing.install_from_env("decode-worker")
    obs_tracing.event("decode_worker_start", pid=os.getpid())
    into = getattr(parse_fn, "into", None)
    slabs = {}  # name -> SlabSegment kept attached across rounds
    while True:
        try:
            task = conn.recv()
        except (EOFError, OSError):
            break
        seq, slab_name, slot, geom, rec = task
        try:
            batch_size, shape, dtype = geom
            slab = slabs.get(slab_name)
            if slab is None:
                slab = slabs[slab_name] = SlabSegment.attach(slab_name)
            view = slab.ndarray((batch_size,) + tuple(shape), dtype)
            if into is not None:
                # native fast path: decode straight into the slab slot (no
                # PIL, no intermediate copy); falls back to PIL internally
                lbl, native = into(rec, view[slot])
            else:
                img, lbl = parse_fn(rec)
                view[slot] = img  # raises on shape/dtype mismatch vs slot 0
                native = False
            ack = (seq, slot, True, (int(lbl), bool(native)))
        except Exception as e:
            ack = (seq, slot, False, "{}: {}".format(type(e).__name__, e))
        try:
            conn.send(ack)
        except (BrokenPipeError, OSError):
            break
    for slab in slabs.values():
        slab.close()
    conn.close()


class _Worker:
    """Parent-side handle: the process plus its dedicated duplex pipe."""

    __slots__ = ("proc", "conn")

    def __init__(self, proc, conn):
        self.proc = proc
        self.conn = conn


class DecodePlane:
    """A pool of decode worker processes plus the slab pool they write into.

    Construct (and thereby fork the workers) BEFORE starting any pipeline
    threads — fork-with-threads is the one lifecycle hazard here, and the
    loader's ``__iter__`` spawns the plane first for exactly that reason.
    Respawns after a worker death do fork with threads running; the child
    immediately enters pipe/numpy-only code, the same envelope
    ``multiprocessing.Pool`` lives in.

    The round protocol (:meth:`run_round`) preserves the loader's
    byte-identical stream contract: the caller keeps its slot-assignment
    algorithm (records to the lowest free slots, failures leave holes) and
    the plane only changes *where* the decode runs.
    """

    def __init__(self, parse_fn, workers, autotuner=None):
        if workers < 1:
            raise ValueError("DecodePlane needs at least one worker")
        import multiprocessing

        self._ctx = multiprocessing.get_context("fork")
        self._parse_fn = parse_fn
        self._autotuner = autotuner
        self._workers = []
        self._retired = []  # closed-off workers still to be reaped
        self._slabs = {}  # slab name -> SlabSegment (creator side)
        self._names = {}  # id(image view) -> slab name
        self._geom = None
        self._seq = 0
        self._closed = False
        self._workers_g = obs.gauge(
            "decode_workers", help="decode worker processes currently pooled"
        )
        self._restarts_c = obs.counter(
            "decode_worker_restarts_total",
            help="decode workers respawned after dying mid-round",
        )
        self._slab_bytes_g = obs.gauge(
            "decode_slab_bytes", help="bytes resident in the decode slab pool"
        )
        self._slab_wait_c = obs.counter(
            "decode_slab_wait_seconds_total",
            help="seconds the producer waited on an empty slab free list",
        )
        self._native_c = obs.counter(
            "decode_native_total",
            help="records decoded by the native JPEG path (no PIL)",
        )
        for _ in range(int(workers)):
            self._spawn()

    # -- worker lifecycle -------------------------------------------------------

    def _spawn(self):
        parent_conn, child_conn = self._ctx.Pipe(duplex=True)
        proc = self._ctx.Process(
            target=_worker_main,
            args=(child_conn, self._parse_fn, [w.conn for w in self._workers] + [parent_conn]),
            name="tos-decode-worker",
            daemon=True,
        )
        proc.start()
        child_conn.close()  # the child's end lives in the child only
        self._workers.append(_Worker(proc, parent_conn))
        self._workers_g.set(len(self._workers))

    @property
    def workers(self):
        """Current pool size (retired workers excluded)."""
        return len(self._workers)

    def _on_death(self, worker, restart=True):
        """Remove a dead worker; respawn a replacement unless tearing
        down. Returns the replacement (or None)."""
        if worker in self._workers:
            self._workers.remove(worker)
        try:
            worker.conn.close()
        except OSError:
            pass
        worker.proc.join(timeout=0)
        self._workers_g.set(len(self._workers))
        if not restart or self._closed:
            return None
        self._restarts_c.inc()
        logger.warning("decode worker pid %s died; respawning", worker.proc.pid)
        self._spawn()
        return self._workers[-1]

    def resize(self, target):
        """Move the pool toward ``target`` workers: growth forks
        immediately, shrink retires the newest workers by closing their
        pipes (the worker sees EOF after finishing its current lease and
        exits — no round is ever interrupted)."""
        target = max(1, int(target))
        while len(self._workers) < target:
            self._spawn()
        while len(self._workers) > target:
            w = self._workers.pop()
            try:
                w.conn.close()
            except OSError:
                pass
            self._retired.append(w.proc)
        self._workers_g.set(len(self._workers))

    def autotune_tick(self):
        """Give the :class:`DecodeAutotuner` (when configured) a chance to
        resize from the measured stall counters; call between rounds."""
        if self._autotuner is None:
            return
        target = self._autotuner.tick(len(self._workers))
        if target is not None and target != len(self._workers):
            logger.info(
                "decode autotuner: %d -> %d workers", len(self._workers), target
            )
            self.resize(target)

    # -- slab pool --------------------------------------------------------------

    def new_slab(self, batch_size, shape, dtype):
        """Mint one pooled slab sized for a ``[B,H,W,C]`` batch and return
        its zero-copy image view plus a parent-side label buffer. The view
        circulates through the loader's free queue; the plane keeps the
        segment (and the view→name mapping the lease protocol needs)."""
        self._geom = (int(batch_size), tuple(shape), np.dtype(dtype).str)
        nbytes = int(batch_size) * int(np.prod(shape)) * np.dtype(dtype).itemsize
        slab = SlabSegment.create(nbytes)
        self._slabs[slab.name] = slab
        images = slab.ndarray((batch_size,) + tuple(shape), dtype)
        self._names[id(images)] = slab.name
        self._slab_bytes_g.set(float(sum(s.nbytes for s in self._slabs.values())))
        return images, np.empty((batch_size,), np.int32)

    # -- the slot lease protocol ------------------------------------------------

    def run_round(self, images, labels, tasks, should_stop=None):
        """Decode ``tasks`` — ``[(slot, record bytes), ...]`` — into the
        slab behind ``images``, filling ``labels`` parent-side from the
        acks. Returns ``[(slot, DecodeWorkerError), ...]`` for records that
        failed to parse (same contract as the thread pool's per-slot
        results; the caller absorbs within its ``max_bad_records`` budget).

        Liveness: a worker death surfaces as EOF on its own pipe (no
        shared lock a SIGKILL could strand); its un-acked slots are
        re-leased to the respawned pool. Stale acks (earlier ``seq``) and
        duplicate acks are dropped — slab writes are idempotent because
        ``parse_fn`` is deterministic per record.
        """
        from multiprocessing import connection

        if not tasks:
            return []
        if self._geom is None:
            raise RuntimeError("run_round before new_slab: no batch geometry")
        self._seq += 1
        seq = self._seq
        name = self._names[id(images)]
        by_slot = dict(tasks)
        pending = set(by_slot)
        needs = sorted(pending)  # slots awaiting (re-)lease
        owner = {}  # slot -> _Worker currently leasing it
        failures = []

        def _check_stop():
            if should_stop is not None and should_stop():
                raise Stopped()

        def _reap(worker):
            # a dead worker takes its in-flight leases with it
            replacement = self._on_death(worker)
            orphans = sorted(s for s, w in owner.items() if w is worker and s in pending)
            for s in orphans:
                del owner[s]
            needs.extend(orphans)
            return replacement

        def _drain(timeout):
            conns = {w.conn: w for w in self._workers}
            if not conns:
                return
            for conn in connection.wait(list(conns), timeout=timeout):
                worker = conns[conn]
                try:
                    ack_seq, slot, ok, payload = conn.recv()
                except (EOFError, OSError):
                    _reap(worker)
                    continue
                if ack_seq != seq or slot not in pending:
                    continue  # stale round, or a duplicate after a re-lease
                pending.discard(slot)
                owner.pop(slot, None)
                if ok:
                    labels[slot] = payload[0]
                    if payload[1]:
                        self._native_c.inc()
                else:
                    failures.append((slot, DecodeWorkerError(payload)))

        first_wave = True
        while pending:
            _check_stop()
            while needs:
                todo, needs[:] = list(needs), []
                for i, slot in enumerate(todo):
                    while not self._workers:
                        self._spawn()  # the whole pool died at once
                    worker = self._workers[i % len(self._workers)]
                    try:
                        worker.conn.send((seq, name, slot, self._geom, by_slot[slot]))
                        owner[slot] = worker
                    except (BrokenPipeError, OSError):
                        needs.append(slot)
                        _reap(worker)
                # keep the ack direction drained while leasing, so a big
                # round can never wedge on two full pipe buffers
                _drain(0)
            if first_wave:
                first_wave = False
                self._maybe_chaos_kill()
            if pending:
                _drain(ACK_POLL_SECONDS)
        return failures

    def _maybe_chaos_kill(self):
        """``data.decode_kill``: SIGKILL one live worker mid-round. Rolled
        parent-side so the seeded schedule is independent of worker timing
        and the fault counter lands in the registry that reaches the
        cluster merge."""
        if not (chaos.active and chaos.fire("data.decode_kill")):
            return
        victim = next((w for w in self._workers if w.proc.is_alive()), None)
        if victim is not None:
            logger.warning("chaos: SIGKILL decode worker pid %d", victim.proc.pid)
            os.kill(victim.proc.pid, signal.SIGKILL)

    # -- teardown ---------------------------------------------------------------

    def close(self, timeout=5.0):
        """Clean drain: close every lease pipe (workers exit at EOF after
        their current task), join with a deadline, SIGKILL stragglers,
        then unlink the slab pool. Idempotent — both the producer's
        teardown and the consumer's ``finally`` may land here."""
        if self._closed:
            return
        self._closed = True
        procs = [w.proc for w in self._workers] + self._retired
        for w in self._workers:
            try:
                w.conn.close()
            except OSError:
                pass
        self._workers = []
        self._retired = []
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(timeout=1.0)
        self._workers_g.set(0)
        for slab in self._slabs.values():
            # release, not close: emitted batch views may outlive the plane
            # (the consumer's last batch) — the mapping follows the views
            slab.release()
        self._slabs = {}
        self._names = {}
        self._slab_bytes_g.set(0)

    def note_slab_wait(self, seconds):
        """Wait-accounting hook: the loader calls this when its buffer
        acquire blocked on the slab free list."""
        self._slab_wait_c.inc(seconds)


class DecodeAutotuner:
    """Self-sizing controller for the decode worker count.

    Mirrors :class:`~tensorflowonspark_tpu_torch.data.autotune.FeedAutotuner`'s
    discipline on a different pair of measurements: the deltas of
    ``data_producer_parse_seconds_total`` (is the parse stage busy?) and
    ``data_consumer_wait_seconds_total`` (is the training loop starving?)
    over each observation interval.

    Decision rule per interval of ``check_every`` seconds:

    * consumer starved for more than ``starve_ratio`` of the interval AND
      parse dominated the wait → the decode plane is the bottleneck:
      **grow one worker immediately** (starvation is expensive *now*).
    * consumer essentially never starved (wait share below ``idle_ratio``)
      → the input path is ahead of the consumer: **shrink one worker after
      ``down_patience`` consecutive idle intervals** (hysteresis against
      mood flicker — flapping thrashes the fork rate for nothing).

    Bounds: ``[min_workers, max_workers]`` (default 1 .. ``os.cpu_count()``).
    The counter reads are injectable (``read_counters``), so the decision
    core is a pure function of its inputs in tests, like the feed
    autotuner's injectable clock.
    """

    def __init__(
        self,
        min_workers=1,
        max_workers=None,
        starve_ratio=0.05,
        idle_ratio=0.01,
        down_patience=2,
        check_every=2.0,
        clock=None,
        read_counters=None,
    ):
        self.min_workers = max(1, int(min_workers))
        self.max_workers = int(max_workers or (os.cpu_count() or 1))
        if self.max_workers < self.min_workers:
            raise ValueError("max_workers must be >= min_workers")
        self.starve_ratio = float(starve_ratio)
        self.idle_ratio = float(idle_ratio)
        self.down_patience = max(1, int(down_patience))
        self.check_every = float(check_every)
        # the shared control core: starvation verdict, up-fast/down-slow
        # hysteresis inside the worker bounds, and the clocked delta gate
        self._rule = StallRule(
            starve_ratio=self.starve_ratio, idle_ratio=self.idle_ratio
        )
        self._ctl = Controller(
            lo=self.min_workers, hi=self.max_workers,
            down_patience=self.down_patience, name="decode_workers",
        )
        self._ticker = DeltaTicker(
            self.check_every, read_counters or self._read_obs, clock=clock
        )

    @staticmethod
    def _read_obs():
        counters = obs.snapshot()["counters"]

        def _c(counter_name):
            return counters.get(counter_name, {}).get("value", 0.0)

        return (
            _c("data_producer_parse_seconds_total"),
            _c("data_consumer_wait_seconds_total"),
        )

    def decide(self, workers, parse_delta, wait_delta, elapsed):
        """Pure decision: the worker count argued for by one interval's
        counter deltas (no clock, no obs — the unit-testable core)."""
        if elapsed <= 0:
            return workers
        want = self._rule.want(wait_delta / elapsed, parse_delta >= wait_delta)
        return self._ctl.step(workers, want)

    def tick(self, workers):
        """Clocked wrapper for :meth:`decide`: reads the counters at most
        every ``check_every`` seconds; returns the new target count, or
        None when the interval has not elapsed yet."""
        out = self._ticker.tick()
        if out is None:
            return None
        (parse_delta, wait_delta), elapsed = out
        return self.decide(workers, parse_delta, wait_delta, elapsed)
