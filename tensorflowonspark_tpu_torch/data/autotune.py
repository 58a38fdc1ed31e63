"""Adaptive device-feed autotuner: online link probing + dynamic packed
windows, and the stall-steered shard read-ahead — copied from the JAX
package's ``data/autotune.py``, with the link probes rewritten on CUDA
events.

The packed-window size ``K`` amortizes the host→device link's per-transfer
fixed cost (``compile_train_loop(packed=True)`` +
:func:`~tensorflowonspark_tpu_torch.data.packed_prefetch`); this module
chooses it *online*, the way tf.data's AUTOTUNE and Plumber tune input
pipelines by measurement instead of configuration.

The pieces:

* :class:`LinkEstimator` — the two-parameter cost model
  ``T(bytes) = fixed + bytes / bytes_per_sec``. The *fixed* term is
  estimated from timed, fenced micro-probes (a few bytes: stream time is
  negligible, so the probe time IS the fixed cost); the *stream* term from
  timed, fenced production window transfers (observed time minus the
  current fixed estimate). Both update through an EWMA, seeded one-shot by
  the first observation of each kind.
* :class:`FeedAutotuner` — the controller: owns the estimator, a bounded
  bucket set of window sizes (powers of two, default ``{1, 2, 4, 8, 16}``
  so the per-K captured loops stay few), and the decision rule:
  the smallest bucket whose predicted fixed-cost share
  ``fixed / T(K · batch_bytes)`` is at or below ``overhead_target``.
  Upward moves apply immediately (a latency spike is expensive *now*);
  downward moves wait for ``down_patience`` consecutive recommendations.
  Prefetch depth comes along for free: small windows pipeline ``depth=2``
  ahead, large windows (≥ ``deep_window_k``) hold device memory to the
  double buffer (current + one in flight). Its transfers go through
  :class:`~tensorflowonspark_tpu_torch.data.loader.PinnedPlacer` (stacked
  into one pinned buffer, sent on the copy stream) — the port's one
  placement path — and are fenced on the placement's CUDA event.
* :func:`autotuned_prefetch` — the drop-in sibling of
  :func:`~tensorflowonspark_tpu_torch.data.loop_prefetch` /
  :func:`~tensorflowonspark_tpu_torch.data.packed_prefetch`: groups host batches
  into device-resident ``[K, B, ...]`` stacks where ``K`` follows the
  controller, windows double-buffered ``depth`` ahead. The delivered batch
  stream is **byte-identical regardless of K** (batches are grouped in
  arrival order and the source tail is flushed by binary decomposition
  into bucket-sized windows, so nothing is dropped and every window size
  is a bucket). Run a window with a loop built for its ``k``
  (``train.PackedLoopCache``: one a bucket, built on first use).
* :class:`ReadaheadAutotuner` — sizes the shard read-ahead from the stall
  counters (``ImagePipeline(readahead="auto")``, the store's prefetch
  window).

Every decision is exported through :mod:`~tensorflowonspark_tpu_torch.obs` and
surfaces in ``TFCluster.metrics()``:

==================================  =======================================
metric                              meaning
==================================  =======================================
``feed_link_bytes_per_sec``         current stream-bandwidth estimate
``feed_transfer_fixed_cost_seconds``current per-transfer fixed-cost estimate
``feed_window_size``                the K the controller currently feeds
``feed_recompiles_total``           packed-loop compilations (≤ one/bucket)
``feed_transfer_seconds_total``     fenced wall time spent in transfers
``readahead_depth``                 shard read-ahead depth currently allowed
==================================  =======================================

The ``data.device_link`` chaos site injects a per-transfer delay inside the
timed region (probes and production windows alike), which makes adaptation
deterministically testable: raise the injected latency mid-run and the
controller must move K up; drop it and K must come back down.
"""

import collections
import logging
import time

from tensorflowonspark_tpu_torch import chaos, obs
from tensorflowonspark_tpu_torch.control import Controller, DeltaTicker, EwmaEstimator, StallRule

logger = logging.getLogger(__name__)

#: default bounded bucket set for the packed-window size K: powers of two,
#: so the per-K compiled-loop cache holds at most 5 programs and any source
#: tail decomposes exactly into bucket-sized windows (binary representation)
DEFAULT_BUCKETS = (1, 2, 4, 8, 16)

#: resolvability threshold for the stream term: an observed transfer whose
#: time beyond the fixed-cost estimate is below this says nothing about
#: bandwidth (dividing by ~0 would poison the model with a near-infinite
#: estimate that takes many windows to forget), so such samples only feed
#: the fixed-cost clamp
MIN_STREAM_SECONDS = 1e-6


class LinkEstimator:
    """EWMA estimate of the link cost model ``T(bytes) = fixed + bytes/bw``.

    ``alpha`` is the EWMA weight of the newest observation (0.3 default:
    responsive within a handful of windows, yet one freak sample cannot
    swing a bucket decision by itself). The first observation of each kind
    seeds its parameter directly — the one-shot probe contract.
    """

    def __init__(self, alpha=0.3):
        # one shared EWMA core (validates alpha) blending both model terms
        # under the same weight — the seed-on-first-observation semantics
        # live in control.EwmaEstimator now
        self._blender = EwmaEstimator(alpha=alpha)
        self.alpha = self._blender.alpha
        self.fixed_s = None
        self.bytes_per_sec = None

    @property
    def ready(self):
        """True once both model parameters have at least one observation."""
        return self.fixed_s is not None and self.bytes_per_sec is not None

    def _ewma(self, old, new):
        return self._blender.blend(old, new)

    def observe_fixed(self, seconds):
        """Feed one timed micro-probe (payload small enough that stream time
        is negligible): the sample IS the per-transfer fixed cost."""
        self.fixed_s = self._ewma(self.fixed_s, max(0.0, seconds))

    def observe(self, nbytes, seconds):
        """Feed one timed, fenced production transfer of ``nbytes``.

        The stream share is ``seconds`` minus the current fixed estimate; a
        transfer that beats the fixed estimate also drags ``fixed_s`` down
        (the link cannot have a fixed cost larger than a whole observed
        transfer), so the model recovers even if the probe caught a spike.
        A transfer that fits entirely inside the fixed estimate resolves no
        stream share at all and leaves the bandwidth estimate untouched.
        """
        if nbytes <= 0 or seconds <= 0:
            return
        if self.fixed_s is None:
            self.fixed_s = 0.0
        if seconds < self.fixed_s:
            self.fixed_s = self._ewma(self.fixed_s, seconds)
        stream = seconds - self.fixed_s
        if stream < MIN_STREAM_SECONDS:
            return
        self.bytes_per_sec = self._ewma(self.bytes_per_sec, nbytes / stream)

    def predict(self, nbytes):
        """Predicted transfer seconds for ``nbytes`` under the current model
        (None until :attr:`ready`)."""
        if not self.ready:
            return None
        return self.fixed_s + nbytes / max(self.bytes_per_sec, 1e-9)

    def fixed_share(self, nbytes):
        """Fraction of a predicted ``nbytes`` transfer spent on the fixed
        cost — the quantity the window size K exists to amortize."""
        total = self.predict(nbytes)
        if not total:
            return 0.0
        return self.fixed_s / total


class AutotunedWindow:
    """One device-resident packed window: ``data`` is the ``[k, B, ...]``
    dict of tensors (stacked by :class:`~tensorflowonspark_tpu_torch.data.
    loader.PinnedPlacer`), ``k`` the bucket it was built for — feed it to a
    loop compiled for ``k`` steps with ``packed=True``."""

    __slots__ = ("data", "k")

    def __init__(self, data, k):
        self.data = data
        self.k = k


class FeedAutotuner:
    """Online controller for the packed-window size K and prefetch depth.

    Decision rule: the smallest bucket whose predicted fixed-cost share
    ``fixed / (fixed + K·batch_bytes/bw)`` is ≤ ``overhead_target``
    (default 0.1 — at the measured ~250 ms fixed cost and ~20 MB/s this
    lands on K=8). Upward
    moves apply immediately; downward moves need ``down_patience``
    consecutive lower recommendations. Every ``reprobe_every``-th window a
    fenced micro-probe refreshes the fixed-cost estimate, so a mood change
    is seen even while the window size (and thus the bytes term) is
    steady.

    ``clock`` is injectable for deterministic tests (defaults to
    ``time.perf_counter``); the estimator itself is pure arithmetic and can
    be driven directly through :meth:`note_fixed_probe` /
    :meth:`note_transfer`.
    """

    def __init__(
        self,
        buckets=DEFAULT_BUCKETS,
        overhead_target=0.1,
        down_patience=2,
        reprobe_every=4,
        deep_window_k=8,
        alpha=0.3,
        clock=None,
    ):
        if not buckets:
            raise ValueError("buckets must be non-empty")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if any(b < 1 for b in self.buckets):
            raise ValueError("buckets must be >= 1")
        if not 0.0 < overhead_target < 1.0:
            raise ValueError("overhead_target must be in (0, 1)")
        self.overhead_target = overhead_target
        self.down_patience = max(1, int(down_patience))
        self.reprobe_every = max(0, int(reprobe_every))
        self.deep_window_k = int(deep_window_k)
        self.estimator = LinkEstimator(alpha=alpha)
        self._clock = clock or time.perf_counter
        self._k = None
        # the shared hysteresis core: up one bucket immediately, down one
        # bucket after down_patience consecutive lower recommendations
        self._ctl = Controller(
            levels=self.buckets, down_patience=self.down_patience,
            name="feed_window",
        )
        self._windows_placed = 0
        self._placer_of = None  # (strategy, PinnedPlacer) of the last place()
        # instruments created eagerly so the five feed_* metrics exist in
        # every snapshot that saw a tuner, even before the first transfer
        self._bw_g = obs.gauge(
            "feed_link_bytes_per_sec",
            help="autotuner estimate of the host->device stream bandwidth",
        )
        self._fixed_g = obs.gauge(
            "feed_transfer_fixed_cost_seconds",
            help="autotuner estimate of the per-transfer fixed cost",
        )
        self._k_g = obs.gauge(
            "feed_window_size", help="packed-window size K currently fed"
        )
        obs.counter(
            "feed_recompiles_total",
            help="packed train-loop compilations (bounded by the bucket set)",
        )
        self._transfer_c = obs.counter(
            "feed_transfer_seconds_total",
            help="fenced wall seconds spent in host->device window transfers",
        )

    # -- estimator feeding (pure; used by the timed paths below) ---------------

    def note_fixed_probe(self, seconds):
        """Record one fixed-cost probe sample and publish the estimate."""
        self.estimator.observe_fixed(seconds)
        self._fixed_g.set(self.estimator.fixed_s)

    def note_transfer(self, nbytes, seconds):
        """Record one production window transfer and publish the estimates."""
        self.estimator.observe(nbytes, seconds)
        self._transfer_c.inc(seconds)
        if self.estimator.bytes_per_sec is not None:
            self._bw_g.set(self.estimator.bytes_per_sec)
        if self.estimator.fixed_s is not None:
            self._fixed_g.set(self.estimator.fixed_s)

    # -- the decision -----------------------------------------------------------

    def recommend(self, batch_bytes):
        """The bucket the model currently argues for (no hysteresis)."""
        if not self.estimator.ready or batch_bytes <= 0:
            return self.buckets[0]
        for k in self.buckets:
            if self.estimator.fixed_share(k * batch_bytes) <= self.overhead_target:
                return k
        return self.buckets[-1]

    def decide(self, batch_bytes):
        """Select ``(k, depth)`` for the NEXT window and publish the choice.

        The first call jumps straight to the recommendation (the one-shot
        probe seeded the model; there is no history to be cautious about);
        after that, K moves at most one bucket per call — up immediately,
        down only after ``down_patience`` consecutive lower
        recommendations.
        """
        rec = self.recommend(batch_bytes)
        if self._k is None:
            self._k = rec
        else:
            self._k = self._ctl.toward(self._k, rec)
        self._k_g.set(self._k)
        return self._k, self.depth(self._k)

    def depth(self, k):
        """Windows kept in flight beyond the one handed out: 2 for small
        windows (cheap, deep pipeline), 1 from ``deep_window_k`` up (the
        double buffer — current window training, one window in transfer —
        bounds device memory at ~2 windows like the static packed path)."""
        return 1 if k >= self.deep_window_k else 2

    # -- timed, fenced placement ------------------------------------------------

    def _placer(self, strategy):
        """The tuner's :class:`~tensorflowonspark_tpu_torch.data.loader.
        PinnedPlacer`: enough pinned slots for the windows in flight (the
        deepest depth, the one handed out, and the probe)."""
        if self._placer_of is None or self._placer_of[0] is not strategy:
            from tensorflowonspark_tpu_torch.data.loader import PinnedPlacer

            self._placer_of = (strategy, PinnedPlacer(strategy, 4))
        return self._placer_of[1]

    @staticmethod
    def _fence(event):
        """Wait until a placement's transfer has landed: its CUDA event
        (None on the CPU, where placement is synchronous)."""
        if event is not None:
            event.synchronize()

    def _fire_link_chaos(self):
        if chaos.active:
            spec = chaos.fire("data.device_link")
            if spec is not None:
                time.sleep(spec.get("delay_s", 0.05))

    def probe_fixed(self, strategy):
        """One fenced micro-transfer (8 bytes: pure fixed cost) through the
        same placement path as production windows; feeds the fixed
        estimate."""
        import numpy as np

        payload = [{"probe": np.zeros(8, np.uint8)}]
        t0 = self._clock()
        self._fire_link_chaos()
        _, event = self._placer(strategy).place(payload, stacked=True)
        self._fence(event)
        self.note_fixed_probe(self._clock() - t0)

    def place(self, window, strategy):
        """Stack ``window`` (list of host batch dicts) into one transfer
        through ``PinnedPlacer.place(..., stacked=True)``, timed and fenced
        on its CUDA event, feeding the estimator. Returns an
        :class:`AutotunedWindow`."""
        if self.reprobe_every and self._windows_placed % self.reprobe_every == 0:
            self.probe_fixed(strategy)
        self._windows_placed += 1
        nbytes = sum(batch_nbytes(batch) for batch in window)
        # the h2d phase of the step timeline: the same fenced interval that
        # feeds the estimator becomes a span for the merged trace
        with obs.span("h2d_transfer", nbytes=nbytes, k=len(window)):
            t0 = self._clock()
            self._fire_link_chaos()
            placed, event = self._placer(strategy).place(window, stacked=True)
            self._fence(event)
            self.note_transfer(nbytes, self._clock() - t0)
        return AutotunedWindow(placed, len(window))


#: default upper bound for the stall-steered shard read-ahead depth
#: (``ImagePipeline(readahead="auto")``): deep enough to hide a slow remote
#: store behind decode, small enough that chunk queues stay bounded
DEFAULT_MAX_READAHEAD = 8


class ReadaheadAutotuner:
    """Self-sizing controller for the shard read-ahead depth.

    The third member of the autotuner family: :class:`FeedAutotuner` sizes
    the packed device window, :class:`~tensorflowonspark_tpu_torch.data.decode_plane.DecodeAutotuner`
    sizes the decode worker pool, and this one sizes how many shards the
    reader executor streams ahead of the parse stage — the knob that
    matters when the stall classification says **io_bound** (remote stores:
    gcsfuse, NFS, object stores with high per-read latency).

    Decision rule per interval of ``check_every`` seconds, from the deltas
    of the producer/consumer stall counters (the same accounting
    ``bench.classify_stalls`` reads):

    * consumer starved for more than ``starve_ratio`` of the interval AND
      shard IO dominated the parse stage (``read_delta >= parse_delta`` —
      the interval was io_bound, not decode_bound) → **deepen read-ahead
      one shard immediately**. Starvation whose cause is decode is left to
      the decode autotuner; deepening read-ahead cannot fix it.
    * consumer essentially never starved (wait share below ``idle_ratio``)
      → **shallow by one after ``down_patience`` consecutive idle
      intervals** (hysteresis), releasing reader threads and chunk-queue
      memory the pipeline demonstrably does not need.

    Bounds ``[min_depth, max_depth]``. Counter reads and the clock are
    injectable so the decision core is a pure function in tests, exactly
    like the decode autotuner. Publishes the chosen depth on the
    ``readahead_depth`` gauge.
    """

    def __init__(
        self,
        min_depth=1,
        max_depth=DEFAULT_MAX_READAHEAD,
        starve_ratio=0.05,
        idle_ratio=0.01,
        down_patience=2,
        check_every=2.0,
        clock=None,
        read_counters=None,
        gauge=None,
    ):
        self.min_depth = max(1, int(min_depth))
        self.max_depth = int(max_depth)
        if self.max_depth < self.min_depth:
            raise ValueError("max_depth must be >= min_depth")
        self.starve_ratio = float(starve_ratio)
        self.idle_ratio = float(idle_ratio)
        self.down_patience = max(1, int(down_patience))
        self.check_every = float(check_every)
        # the shared control core: starvation verdict, up-fast/down-slow
        # hysteresis inside the depth bounds, and the clocked delta gate
        self._rule = StallRule(
            starve_ratio=self.starve_ratio, idle_ratio=self.idle_ratio
        )
        self._ctl = Controller(
            lo=self.min_depth, hi=self.max_depth,
            down_patience=self.down_patience, name="readahead",
        )
        self._ticker = DeltaTicker(
            self.check_every, read_counters or self._read_obs, clock=clock
        )
        # the depth gauge is injectable so other read-ahead-shaped planes
        # (the store prefetch stager) can reuse the whole controller while
        # publishing on their own metric name
        self._depth_g = gauge if gauge is not None else obs.gauge(
            "readahead_depth", help="shard read-ahead depth currently allowed"
        )

    @staticmethod
    def _read_obs():
        counters = obs.snapshot()["counters"]

        def _c(counter_name):
            return counters.get(counter_name, {}).get("value", 0.0)

        return (
            _c("data_producer_read_seconds_total"),
            _c("data_producer_parse_seconds_total"),
            _c("data_consumer_wait_seconds_total"),
        )

    def publish(self, depth):
        """Publish ``depth`` on the ``readahead_depth`` gauge (the loader
        calls this once at startup so the gauge exists before the first
        interval elapses)."""
        self._depth_g.set(int(depth))

    def decide(self, depth, read_delta, parse_delta, wait_delta, elapsed):
        """Pure decision: the read-ahead depth argued for by one interval's
        counter deltas (no clock, no obs — the unit-testable core)."""
        if elapsed <= 0:
            return depth
        want = self._rule.want(wait_delta / elapsed, read_delta >= parse_delta)
        return self._ctl.step(depth, want)

    def tick(self, depth):
        """Clocked wrapper for :meth:`decide`: reads the counters at most
        every ``check_every`` seconds; returns the new target depth, or
        None when the interval has not elapsed yet."""
        out = self._ticker.tick()
        if out is None:
            return None
        (read_delta, parse_delta, wait_delta), elapsed = out
        target = self.decide(depth, read_delta, parse_delta, wait_delta, elapsed)
        if target != depth:
            self._depth_g.set(int(target))
        return target


def batch_nbytes(batch):
    """Host-side bytes of one batch (a dict, list or tuple of arrays,
    nested) — the controller's size unit."""
    import numpy as np

    if isinstance(batch, dict):
        return sum(batch_nbytes(v) for v in batch.values())
    if isinstance(batch, (list, tuple)):
        return sum(batch_nbytes(v) for v in batch)
    return np.asarray(batch).nbytes


def bucket_decomposition(n, buckets):
    """Greedy decomposition of ``n`` batches into bucket-sized windows,
    largest first — with power-of-two buckets down to 1 this is the binary
    representation of ``n``, so the source tail is delivered exactly and
    every emitted window size has (or will have) a cached compiled loop.
    Any residue smaller than the smallest bucket is dropped (impossible
    when 1 is a bucket)."""
    sizes = []
    for b in sorted(buckets, reverse=True):
        while n >= b:
            sizes.append(b)
            n -= b
    return sizes


def autotuned_prefetch(batches, strategy, tuner=None, **tuner_kw):
    """Group host batches into device-resident packed windows whose size K
    follows the :class:`FeedAutotuner` — the adaptive sibling of
    :func:`~tensorflowonspark_tpu_torch.data.packed_prefetch`.

    Yields :class:`AutotunedWindow` objects (``.data`` = ``[k, B, ...]``
    device dict, ``.k`` = its bucket); run them with
    :class:`~tensorflowonspark_tpu_torch.train.strategy.PackedLoopCache`,
    which builds a loop a bucket on first use (on the card all of them
    replay one captured step)::

        tuner = FeedAutotuner()
        cache = PackedLoopCache(strategy, loss_fn, optimizer, mutable=True)
        for window in autotuned_prefetch(pipe, strategy, tuner=tuner):
            state, metrics = cache.run(state, window)

    The delivered batch stream is byte-identical to the K=1 reference for
    any controller trajectory: batches are grouped strictly in arrival
    order, and the source tail is flushed through
    :func:`bucket_decomposition` instead of being dropped. Windows are
    double-buffered ``tuner.depth(k)`` ahead; the handed-out window stays
    referenced by the consumer while the next transfers.

    Extra keyword arguments construct the default tuner
    (``autotuned_prefetch(pipe, strategy, overhead_target=0.2)``).
    """
    if tuner is None:
        tuner = FeedAutotuner(**tuner_kw)
    it = iter(batches)
    buf = collections.deque()
    pending = []  # host batches drawn but not yet placed
    exhausted = False

    def _pull():
        nonlocal exhausted
        try:
            pending.append(next(it))
            return True
        except StopIteration:
            exhausted = True
            return False

    depth = 1
    while True:
        while not exhausted and len(buf) <= depth:
            if not pending and not _pull():
                break
            k, depth = tuner.decide(batch_nbytes(pending[0]))
            while len(pending) < k and _pull():
                pass
            if len(pending) < k:
                break  # tail: flushed below by bucket decomposition
            buf.append(tuner.place(pending[:k], strategy))
            del pending[:k]
        if exhausted and pending:
            for k in bucket_decomposition(len(pending), tuner.buckets):
                buf.append(tuner.place(pending[:k], strategy))
                del pending[:k]
            pending = []
        if not buf:
            return
        yield buf.popleft()
