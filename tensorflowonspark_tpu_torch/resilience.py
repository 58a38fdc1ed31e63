"""Shared resilience policies: backoff, deadlines, retry budgets, breakers.

Every layer of the stack talks to something that can fail transiently — the
reservation server during assembly, the serving socket under load, the
filesystem under a flaky FUSE mount. Before this module each call site
carried its own ad-hoc loop (a fixed ``2 ** attempt`` sleep here, a bare
re-raise there). This module centralizes the policy vocabulary:

- :class:`Backoff` — exponential backoff schedules with configurable
  jitter. Seedable, so tests can assert the exact schedule.
- :class:`Deadline` — an absolute time budget shared across attempts;
  ``sleep()`` never overshoots it.
- :class:`RetryPolicy` — a bounded retry budget combining the two, with an
  ``on_retry`` hook for caller-side accounting.
- :class:`CircuitBreaker` — closed/open/half-open, for callers that should
  stop hammering a peer that is clearly down.

All stdlib; safe to import from any process (driver, executor, jax child).
Retries and give-ups are counted in the :mod:`~tensorflowonspark_tpu_torch.obs`
registry (``resilience_retries_total`` / ``resilience_giveups_total``).
"""

import random
import threading
import time

from tensorflowonspark_tpu_torch import obs


class DeadlineExceeded(Exception):
    """The operation's time budget ran out before it succeeded."""


class RetryBudgetExhausted(Exception):
    """Every attempt allowed by the policy failed; ``__cause__`` is the
    last underlying error."""


class CircuitOpenError(Exception):
    """The circuit breaker is open; the call was not attempted."""


class Backoff:
    """An exponential backoff schedule: ``base * factor**n`` capped at
    ``max_delay``, with a configurable jitter fraction.

    ``jitter`` is the randomized fraction of each delay: ``0.0`` yields the
    deterministic schedule, ``1.0`` is "full jitter" (uniform in
    ``[0, delay]``), values in between keep ``(1 - jitter) * delay`` as a
    floor. Pass ``seed`` to make the jittered schedule reproducible —
    :meth:`delays` re-seeds on every call, so two iterations of the same
    ``Backoff`` produce identical schedules.
    """

    def __init__(self, base=0.5, factor=2.0, max_delay=30.0, jitter=1.0, seed=None):
        if base < 0 or factor < 1.0 or max_delay < 0:
            raise ValueError("base/max_delay must be >= 0 and factor >= 1")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        self.base = base
        self.factor = factor
        self.max_delay = max_delay
        self.jitter = jitter
        self.seed = seed

    def delays(self):
        """Yield the (infinite) delay schedule; one generator per burst of
        attempts, re-seeded so schedules are deterministic under a seed."""
        rng = random.Random(self.seed)
        delay = self.base
        while True:
            capped = min(delay, self.max_delay)
            if self.jitter:
                floor = capped * (1.0 - self.jitter)
                yield floor + rng.uniform(0.0, capped - floor)
            else:
                yield capped
            delay = min(delay * self.factor, self.max_delay)

    def attempts(self, deadline=None, sleep=time.sleep):
        """Yield attempt indices ``0, 1, 2, ...``, sleeping this schedule
        *between* attempts (never before the first one).

        With a :class:`Deadline`, the generator stops — instead of
        sleeping — once the budget is spent, and every sleep is clamped so
        it cannot overshoot. That makes ``for/else`` the natural shape for
        poll loops: ``break`` on success, the ``else`` branch is the
        timeout path::

            for _ in Backoff(base=0.1, jitter=0.0).attempts(Deadline(30)):
                if ready():
                    break
            else:
                raise TimeoutError(...)

        Without a deadline the generator is infinite (a paced ticker).
        """
        delays = self.delays()
        n = 0
        while True:
            yield n
            n += 1
            if deadline is not None:
                if deadline.expired():
                    return
                sleep(deadline.clamp(next(delays)))
            else:
                sleep(next(delays))

    def __repr__(self):
        return "Backoff(base={}, factor={}, max_delay={}, jitter={}, seed={})".format(
            self.base, self.factor, self.max_delay, self.jitter, self.seed
        )


class Ticker:
    """A drift-free periodic schedule on the monotonic clock, with jitter.

    Tick *n* is scheduled at ``t0 + n * interval + u_n``, where ``u_n`` is
    uniform in ``± jitter * interval`` (re-drawn per tick). Anchoring every
    tick to ``t0`` instead of "now + interval" keeps the long-run rate exact
    even when tick bodies take time — and the per-tick jitter keeps a fleet
    of N tickers started in the same assembly barrier from firing in
    lockstep (the synchronized-burst problem a heartbeat aggregation tree
    would otherwise amplify). Seedable for deterministic tests; overruns
    skip the sleep rather than sleeping negative.
    """

    def __init__(self, interval, jitter=0.0, seed=None,
                 clock=time.monotonic, sleep=time.sleep):
        if interval <= 0:
            raise ValueError("interval must be > 0")
        if not 0.0 <= jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        self.interval = float(interval)
        self.jitter = float(jitter)
        self.seed = seed
        self._clock = clock
        self._sleep = sleep

    def ticks(self, deadline=None):
        """Yield tick indices ``0, 1, 2, ...``, sleeping until each tick's
        scheduled time between yields. The first tick fires immediately.
        With a :class:`Deadline` the generator stops once the budget is
        spent; without one it is infinite."""
        rng = random.Random(self.seed)
        t0 = self._clock()
        n = 0
        while True:
            yield n
            n += 1
            if deadline is not None and deadline.expired():
                return
            offset = rng.uniform(-self.jitter, self.jitter) * self.interval if self.jitter else 0.0
            due = t0 + n * self.interval + offset
            delay = due - self._clock()
            if deadline is not None:
                if deadline.expired():
                    return
                delay = deadline.clamp(delay)
            if delay > 0:
                self._sleep(delay)

    def __repr__(self):
        return "Ticker(interval={}, jitter={}, seed={})".format(
            self.interval, self.jitter, self.seed
        )


class Deadline:
    """An absolute point on the monotonic clock shared across attempts.

    Unlike a per-attempt timeout, a deadline bounds the *total* time a
    caller is willing to wait — retries and backoff sleeps all draw from
    the same budget.
    """

    def __init__(self, timeout, clock=time.monotonic):
        self._clock = clock
        self.timeout = timeout
        self._expires = None if timeout is None else clock() + timeout

    def remaining(self):
        """Seconds left (``None`` = unbounded); never negative."""
        if self._expires is None:
            return None
        return max(0.0, self._expires - self._clock())

    def expired(self):
        return self._expires is not None and self._clock() >= self._expires

    def check(self):
        """Raise :class:`DeadlineExceeded` if the budget is spent."""
        if self.expired():
            raise DeadlineExceeded("deadline of {}s exceeded".format(self.timeout))

    def clamp(self, delay):
        """Trim ``delay`` so a sleep never overshoots the deadline."""
        rem = self.remaining()
        return delay if rem is None else min(delay, rem)


class RetryPolicy:
    """A bounded retry budget: at most ``max_attempts`` calls, sleeping a
    :class:`Backoff` schedule between them, the whole burst optionally
    bounded by a ``timeout`` (a fresh :class:`Deadline` per :meth:`call`).

    Only exceptions in ``retry_on`` are retried; anything else propagates
    immediately. When the budget runs out the last error propagates as-is
    (callers keep their existing exception contracts); when the *deadline*
    expires between attempts, :class:`DeadlineExceeded` is raised from the
    last error.

    ``on_retry(attempt, exc, delay)`` fires before each backoff sleep —
    call sites use it to keep their own counters and log lines.
    """

    def __init__(
        self,
        max_attempts=3,
        backoff=None,
        retry_on=(OSError,),
        timeout=None,
        on_retry=None,
        sleep=time.sleep,
        name=None,
    ):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.backoff = backoff if backoff is not None else Backoff()
        self.retry_on = retry_on
        self.timeout = timeout
        self.on_retry = on_retry
        self._sleep = sleep
        self.name = name

    def call(self, fn, *args, **kwargs):
        """Invoke ``fn(*args, **kwargs)`` under this policy."""
        deadline = Deadline(self.timeout)
        delays = self.backoff.delays()
        last_err = None
        for attempt in range(self.max_attempts):
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:
                last_err = e
                if attempt >= self.max_attempts - 1:
                    break
                if deadline.expired():
                    obs.counter(
                        "resilience_giveups_total",
                        help="retry bursts that exhausted their budget",
                    ).inc()
                    raise DeadlineExceeded(
                        "{}: deadline exceeded after {} attempts".format(
                            self.name or "retry", attempt + 1
                        )
                    ) from e
                delay = deadline.clamp(next(delays))
                obs.counter(
                    "resilience_retries_total", help="retries performed by shared policies"
                ).inc()
                if self.on_retry is not None:
                    self.on_retry(attempt, e, delay)
                if delay > 0:
                    self._sleep(delay)
        obs.counter(
            "resilience_giveups_total", help="retry bursts that exhausted their budget"
        ).inc()
        raise last_err

    def __call__(self, fn):
        """Decorator form: ``@policy`` wraps ``fn`` in :meth:`call`."""

        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)

        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        wrapped.__doc__ = fn.__doc__
        return wrapped


#: circuit states
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """A minimal circuit breaker for peers that fail persistently.

    Closed (normal) → ``failure_threshold`` consecutive failures open the
    circuit → calls fail fast with :class:`CircuitOpenError` for
    ``reset_timeout`` seconds → the next :meth:`allow` admits exactly ONE
    half-open trial call (concurrent callers keep failing fast until the
    trial resolves) — success closes the circuit, failure reopens it (and
    restarts the timer, without re-counting the trip). Thread-safe; the
    clock is injectable for tests.
    """

    def __init__(self, failure_threshold=5, reset_timeout=30.0, clock=time.monotonic, name=None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = None
        #: True while the single half-open trial call is outstanding
        self._probe_in_flight = False

    @property
    def state(self):
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self):
        # caller holds the lock
        if self._state == OPEN and self._clock() - self._opened_at >= self.reset_timeout:
            self._state = HALF_OPEN
            self._probe_in_flight = False
            obs.counter(
                "circuit_half_open_total",
                help="circuit breaker open -> half-open transitions",
            ).inc()

    def allow(self):
        """True if a call may proceed (transitions open → half-open when
        the reset timeout has elapsed). In HALF_OPEN, exactly one caller is
        admitted as the trial request — the admitting ``allow()`` consumes
        the probe token; concurrent probes are refused until the trial
        reports through :meth:`record_success` / :meth:`record_failure`."""
        with self._lock:
            self._maybe_half_open()
            if self._state == OPEN:
                return False
            if self._state == HALF_OPEN:
                if self._probe_in_flight:
                    return False
                self._probe_in_flight = True
            return True

    def record_success(self):
        with self._lock:
            self._state = CLOSED
            self._failures = 0
            self._opened_at = None
            self._probe_in_flight = False

    def record_failure(self):
        with self._lock:
            self._maybe_half_open()
            if self._state == HALF_OPEN:
                self._trip()
                return
            if self._state == OPEN:
                # a straggler reporting after the circuit already opened
                # (e.g. the losing half of a hedged pair): already counted,
                # no second trip
                return
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._trip()

    def _trip(self):
        # caller holds the lock
        self._state = OPEN
        self._failures = 0
        self._opened_at = self._clock()
        obs.counter("resilience_circuit_open_total", help="circuit breaker trips").inc()
        # cluster-level alias surfaced in TFCluster.metrics() (the
        # resilience_-prefixed counter predates it and is kept for
        # dashboard compatibility)
        obs.counter("circuit_open_total", help="circuit breaker trips").inc()

    def call(self, fn, *args, **kwargs):
        """Invoke ``fn`` through the breaker; raises
        :class:`CircuitOpenError` without calling when open."""
        if not self.allow():
            raise CircuitOpenError("{}: circuit open".format(self.name or "circuit"))
        try:
            result = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result
