"""Unit tests for the shared resilience policies:
backoff schedule determinism under a fixed seed, deadline expiry, and
circuit-breaker open/half-open/close transitions — independent of any
injection site."""

import itertools

import pytest

from tensorflowonspark_tpu_torch import resilience


class TestBackoff:
    def test_deterministic_schedule_without_jitter(self):
        b = resilience.Backoff(base=1.0, factor=2.0, max_delay=5.0, jitter=0.0)
        assert list(itertools.islice(b.delays(), 5)) == [1.0, 2.0, 4.0, 5.0, 5.0]

    def test_seeded_jitter_is_reproducible(self):
        b = resilience.Backoff(base=1.0, factor=2.0, max_delay=30.0, jitter=1.0, seed=42)
        first = list(itertools.islice(b.delays(), 6))
        second = list(itertools.islice(b.delays(), 6))
        assert first == second  # re-seeded per delays() call
        other = resilience.Backoff(base=1.0, factor=2.0, max_delay=30.0, jitter=1.0, seed=43)
        assert first != list(itertools.islice(other.delays(), 6))

    def test_jitter_bounds(self):
        b = resilience.Backoff(base=2.0, factor=2.0, max_delay=16.0, jitter=0.5, seed=7)
        expected_caps = [2.0, 4.0, 8.0, 16.0, 16.0]
        for delay, cap in zip(itertools.islice(b.delays(), 5), expected_caps):
            assert cap * 0.5 <= delay <= cap  # floor = (1 - jitter) * cap

    def test_full_jitter_stays_under_cap(self):
        b = resilience.Backoff(base=1.0, factor=10.0, max_delay=3.0, jitter=1.0, seed=0)
        assert all(0.0 <= d <= 3.0 for d in itertools.islice(b.delays(), 20))

    def test_rejects_bad_parameters(self):
        with pytest.raises(ValueError):
            resilience.Backoff(base=-1)
        with pytest.raises(ValueError):
            resilience.Backoff(factor=0.5)
        with pytest.raises(ValueError):
            resilience.Backoff(jitter=2.0)


class TestTicker:
    """The heartbeat schedule is anchored to the
    monotonic clock (drift-free) and jittered (no lockstep fleets)."""

    def _run(self, ticker, n_ticks, work=0.0):
        """Drive a ticker on a fake clock; returns the sleep durations."""
        now = [100.0]
        sleeps = []

        def clock():
            return now[0]

        def sleep(s):
            sleeps.append(s)
            now[0] += s

        t = resilience.Ticker(
            ticker.interval, jitter=ticker.jitter, seed=ticker.seed,
            clock=clock, sleep=sleep,
        )
        for i in t.ticks():
            now[0] += work  # simulate the tick body taking time
            if i >= n_ticks - 1:
                break
        return sleeps

    def test_drift_free_schedule_without_jitter(self):
        spec = resilience.Ticker(2.0, jitter=0.0)
        assert self._run(spec, 4) == [2.0, 2.0, 2.0]

    def test_tick_body_time_is_absorbed_not_accumulated(self):
        """Each tick is scheduled at t0 + n*interval: a 0.5s body shortens
        the sleep instead of pushing every later tick back (the Backoff
        ticker it replaces slept a full interval after the body)."""
        spec = resilience.Ticker(2.0, jitter=0.0)
        sleeps = self._run(spec, 4, work=0.5)
        assert sleeps == [1.5, 1.5, 1.5]

    def test_overrun_skips_sleep(self):
        spec = resilience.Ticker(1.0, jitter=0.0)
        sleeps = self._run(spec, 3, work=5.0)
        assert sleeps == []  # behind schedule: never sleeps negative

    def test_jitter_bounds_and_reproducibility(self):
        spec = resilience.Ticker(2.0, jitter=0.25, seed=11)
        sleeps = self._run(spec, 20)
        # each due time is n*interval ± jitter*interval around the anchor
        assert all(0.0 <= s <= 3.0 for s in sleeps)
        assert any(s != 2.0 for s in sleeps)
        assert sleeps == self._run(spec, 20)  # seeded: reproducible
        other = resilience.Ticker(2.0, jitter=0.25, seed=12)
        assert sleeps != self._run(other, 20)  # different seed: different phase

    def test_deadline_stops_the_generator(self):
        now = [0.0]
        clock = lambda: now[0]

        def sleep(s):
            now[0] += s

        t = resilience.Ticker(1.0, jitter=0.0, clock=clock, sleep=sleep)
        d = resilience.Deadline(3.5, clock=clock)
        ticks = list(t.ticks(deadline=d))
        # the last sleep is clamped to the deadline edge and that tick still
        # fires — same contract as Backoff.attempts — then the generator ends
        assert ticks == [0, 1, 2, 3, 4]
        assert now[0] == pytest.approx(3.5)

    def test_rejects_bad_parameters(self):
        with pytest.raises(ValueError):
            resilience.Ticker(0.0)
        with pytest.raises(ValueError):
            resilience.Ticker(1.0, jitter=1.0)


class TestDeadline:
    def test_expiry_with_fake_clock(self):
        now = [0.0]
        d = resilience.Deadline(10.0, clock=lambda: now[0])
        assert d.remaining() == 10.0
        assert not d.expired()
        now[0] = 9.0
        assert d.remaining() == pytest.approx(1.0)
        d.check()  # still inside the budget
        now[0] = 10.0
        assert d.expired()
        assert d.remaining() == 0.0
        with pytest.raises(resilience.DeadlineExceeded):
            d.check()

    def test_unbounded(self):
        d = resilience.Deadline(None)
        assert d.remaining() is None
        assert not d.expired()
        d.check()
        assert d.clamp(123.0) == 123.0

    def test_clamp_never_overshoots(self):
        now = [0.0]
        d = resilience.Deadline(5.0, clock=lambda: now[0])
        assert d.clamp(60.0) == 5.0
        now[0] = 4.5
        assert d.clamp(60.0) == pytest.approx(0.5)


class TestRetryPolicy:
    def _policy(self, **kw):
        kw.setdefault("backoff", resilience.Backoff(base=0.0, jitter=0.0))
        kw.setdefault("sleep", lambda s: None)
        return resilience.RetryPolicy(**kw)

    def test_succeeds_after_transient_failures(self):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        assert self._policy(max_attempts=3).call(flaky) == "ok"
        assert len(calls) == 3

    def test_budget_exhaustion_raises_last_error(self):
        def always():
            raise OSError("down")

        with pytest.raises(OSError, match="down"):
            self._policy(max_attempts=2).call(always)

    def test_non_retryable_errors_propagate_immediately(self):
        calls = []

        def boom():
            calls.append(1)
            raise ValueError("fatal")

        with pytest.raises(ValueError):
            self._policy(max_attempts=5, retry_on=(OSError,)).call(boom)
        assert len(calls) == 1

    def test_on_retry_hook_sees_attempt_error_and_delay(self):
        seen = []

        def hook(attempt, exc, delay):
            seen.append((attempt, str(exc), delay))

        def always():
            raise OSError("x")

        with pytest.raises(OSError):
            self._policy(max_attempts=3, on_retry=hook).call(always)
        # hook fires before each backoff sleep: attempts 0 and 1, never the last
        assert [s[0] for s in seen] == [0, 1]

    def test_sleeps_follow_backoff_schedule(self):
        slept = []
        policy = resilience.RetryPolicy(
            max_attempts=4,
            backoff=resilience.Backoff(base=1.0, factor=2.0, max_delay=30.0, jitter=0.0),
            sleep=slept.append,
        )

        def always():
            raise OSError("x")

        with pytest.raises(OSError):
            policy.call(always)
        assert slept == [1.0, 2.0, 4.0]

    def test_deadline_bounds_the_burst(self):
        # a deadline of 0 expires before the first retry sleep
        policy = resilience.RetryPolicy(
            max_attempts=10,
            backoff=resilience.Backoff(base=0.0, jitter=0.0),
            timeout=0.0,
            sleep=lambda s: None,
        )
        calls = []

        def always():
            calls.append(1)
            raise OSError("x")

        with pytest.raises(resilience.DeadlineExceeded):
            policy.call(always)
        assert len(calls) == 1  # no second attempt past the deadline

    def test_decorator_form(self):
        calls = []

        @self._policy(max_attempts=2)
        def flaky():
            calls.append(1)
            if len(calls) < 2:
                raise OSError("t")
            return 7

        assert flaky() == 7

    def test_rejects_zero_attempts(self):
        with pytest.raises(ValueError):
            resilience.RetryPolicy(max_attempts=0)


class TestCircuitBreaker:
    def _breaker(self, now, **kw):
        kw.setdefault("failure_threshold", 2)
        kw.setdefault("reset_timeout", 10.0)
        return resilience.CircuitBreaker(clock=lambda: now[0], **kw)

    def test_closed_to_open_to_half_open_to_closed(self):
        now = [0.0]
        cb = self._breaker(now)
        assert cb.state == resilience.CLOSED
        cb.record_failure()
        assert cb.state == resilience.CLOSED  # below threshold
        cb.record_failure()
        assert cb.state == resilience.OPEN
        assert not cb.allow()
        now[0] = 10.0  # reset timeout elapsed -> half-open probe admitted
        assert cb.state == resilience.HALF_OPEN
        assert cb.allow()
        cb.record_success()
        assert cb.state == resilience.CLOSED

    def test_half_open_failure_reopens_and_restarts_timer(self):
        now = [0.0]
        cb = self._breaker(now)
        cb.record_failure()
        cb.record_failure()
        now[0] = 10.0
        assert cb.state == resilience.HALF_OPEN
        cb.record_failure()  # the probe failed
        assert cb.state == resilience.OPEN
        now[0] = 19.0  # timer restarted at t=10: still open
        assert not cb.allow()
        now[0] = 20.0
        assert cb.allow()

    def test_success_resets_failure_streak(self):
        now = [0.0]
        cb = self._breaker(now, failure_threshold=3)
        cb.record_failure()
        cb.record_failure()
        cb.record_success()  # streak broken
        cb.record_failure()
        cb.record_failure()
        assert cb.state == resilience.CLOSED

    def test_call_fails_fast_when_open(self):
        now = [0.0]
        cb = self._breaker(now)
        calls = []

        def boom():
            calls.append(1)
            raise OSError("down")

        for _ in range(2):
            with pytest.raises(OSError):
                cb.call(boom)
        with pytest.raises(resilience.CircuitOpenError):
            cb.call(boom)
        assert len(calls) == 2  # the open circuit never invoked the function

    def test_call_closes_on_success(self):
        now = [0.0]
        cb = self._breaker(now)
        assert cb.call(lambda: "ok") == "ok"
        assert cb.state == resilience.CLOSED

    def _open_then_half_open(self, now):
        cb = self._breaker(now)
        cb.record_failure()
        cb.record_failure()
        now[0] = 10.0
        assert cb.state == resilience.HALF_OPEN
        return cb

    def test_half_open_admits_exactly_one_probe(self):
        now = [0.0]
        cb = self._open_then_half_open(now)
        assert cb.allow()          # the single trial request
        assert not cb.allow()      # a concurrent caller is refused
        assert not cb.allow()
        # reading the state must NOT consume or grant probe tokens
        assert cb.state == resilience.HALF_OPEN
        assert not cb.allow()
        cb.record_success()
        assert cb.state == resilience.CLOSED
        assert cb.allow()

    def test_half_open_concurrent_probes_race_one_winner(self):
        import threading

        now = [0.0]
        cb = self._open_then_half_open(now)
        admitted = []
        barrier = threading.Barrier(8)

        def probe():
            barrier.wait()
            if cb.allow():
                admitted.append(1)

        threads = [threading.Thread(target=probe) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(admitted) == 1  # exactly one trial passed

    def test_failed_probe_reopens_without_double_counting_trips(self):
        from tensorflowonspark_tpu_torch import obs

        def trips():
            return obs.snapshot()["counters"].get(
                "circuit_open_total", {}
            ).get("value", 0)

        now = [0.0]
        before = trips()
        cb = self._open_then_half_open(now)
        assert trips() - before == 1  # the original trip
        assert cb.allow()
        cb.record_failure()  # the trial failed: re-open, count ONE more trip
        assert cb.state == resilience.OPEN
        assert trips() - before == 2
        # stragglers reporting after the re-open (a losing hedge sibling, a
        # refused concurrent probe's caller) must not re-trip
        cb.record_failure()
        cb.record_failure()
        assert trips() - before == 2
        # and the restarted timer admits a fresh single probe
        now[0] = 20.0
        assert cb.allow()
        assert not cb.allow()
        cb.record_success()
        assert cb.state == resilience.CLOSED
