"""The audited control core: one estimate→decide→patience→apply engine.

Unit coverage for :mod:`tensorflowonspark_tpu_torch.control` — the shared
hysteresis :class:`Controller` every autotuner rebases onto, its estimator
and rule helpers, the clocked delta gate, and the cluster-level
:class:`ClusterScaler` the recovery ladder's regrow poll consults."""

import pytest

from tensorflowonspark_tpu_torch import obs
from tensorflowonspark_tpu_torch.control import (
    ClusterScaler,
    Controller,
    DeltaTicker,
    EwmaEstimator,
    StallRule,
    classify_stalls,
)


def _decisions():
    counters = obs.snapshot()["counters"]
    return (counters.get("control_decisions_total") or {}).get("value", 0.0)


# -- classification ------------------------------------------------------------


class TestClassifyStalls:
    def test_emit_pressure_means_device_bound(self):
        assert classify_stalls(1.0, 1.0, 5.0, 2.0) == "device_bound"

    def test_no_data_at_all_is_device_bound(self):
        # the regrow gate's common case: TENSORFLOW-mode nodes read their
        # own data, so the cluster counters are all zero — compute is the
        # gate and growing is allowed
        assert classify_stalls(0.0, 0.0, 0.0, 0.0) == "device_bound"

    def test_starved_consumer_splits_by_producer_stage(self):
        assert classify_stalls(5.0, 1.0, 0.1, 2.0) == "io_bound"
        assert classify_stalls(1.0, 5.0, 0.1, 2.0) == "decode_bound"


# -- estimator -----------------------------------------------------------------


class TestEwmaEstimator:
    def test_first_observation_seeds_directly(self):
        est = EwmaEstimator(alpha=0.3)
        assert est.value is None
        assert est.observe(10.0) == 10.0

    def test_blend_weights_newest_by_alpha(self):
        est = EwmaEstimator(alpha=0.5)
        est.observe(10.0)
        assert est.observe(20.0) == pytest.approx(15.0)
        assert est.blend(0.0, 8.0) == pytest.approx(4.0)

    def test_alpha_bounds(self):
        with pytest.raises(ValueError, match="alpha"):
            EwmaEstimator(alpha=0.0)
        with pytest.raises(ValueError, match="alpha"):
            EwmaEstimator(alpha=1.5)
        assert EwmaEstimator(alpha=1.0).blend(3.0, 7.0) == 7.0


# -- stall rule ----------------------------------------------------------------


class TestStallRule:
    def test_starved_and_owned_pressure_grows(self):
        assert StallRule().want(0.10, True) == 1

    def test_starved_but_foreign_pressure_holds(self):
        # the consumer is starving, but the stage this knob owns did not
        # dominate: growing would tune the wrong knob
        assert StallRule().want(0.10, False) == 0

    def test_idle_shrinks_and_midband_holds(self):
        rule = StallRule(starve_ratio=0.05, idle_ratio=0.01)
        assert rule.want(0.001, True) == -1
        assert rule.want(0.03, True) == 0


# -- the controller discipline -------------------------------------------------


class TestController:
    def test_requires_a_ladder(self):
        with pytest.raises(ValueError, match="levels or lo/hi"):
            Controller()
        with pytest.raises(ValueError, match="non-empty"):
            Controller(levels=())
        with pytest.raises(ValueError, match="hi must be >= lo"):
            Controller(lo=4, hi=2)

    def test_up_is_immediate_by_default(self):
        ctl = Controller(lo=1, hi=8)
        assert ctl.step(2, +1) == 3

    def test_down_needs_patience(self):
        ctl = Controller(lo=1, hi=8, down_patience=2)
        assert ctl.step(4, -1) == 4  # first lower verdict: hold
        assert ctl.step(4, -1) == 3  # second consecutive: move

    def test_hold_clears_both_streaks(self):
        ctl = Controller(lo=1, hi=8, up_patience=2, down_patience=2)
        assert ctl.step(4, -1) == 4
        assert ctl.step(4, 0) == 4  # the streak dies here
        assert ctl.step(4, -1) == 4  # ...so this is a fresh first verdict
        assert ctl.step(4, +1) == 4  # and an up verdict also resets down
        assert ctl.step(4, -1) == 4

    def test_floor_hold_clears_streak(self):
        # pinned tuner behavior: idle intervals at the floor never
        # accumulate credit toward a move that can't happen
        ctl = Controller(lo=2, hi=8, down_patience=2)
        assert ctl.step(2, -1) == 2
        assert ctl.step(3, -1) == 3  # one verdict above the floor: patience
        assert ctl.step(3, -1) == 2

    def test_ceiling_clamps_and_levels_ladder_walks_rungs(self):
        ctl = Controller(levels=(1, 2, 4, 8))
        assert ctl.step(8, +1) == 8
        assert ctl.step(4, +1) == 8
        assert ctl.toward(2, 8) == 4  # one rung per verdict, not a jump
        assert ctl.toward(4, 4) == 4

    def test_moves_are_counted_holds_are_not(self):
        ctl = Controller(lo=1, hi=8, down_patience=2)
        before = _decisions()
        ctl.step(4, +1)  # move
        ctl.step(5, -1)  # hold (patience)
        ctl.step(5, 0)   # hold
        assert _decisions() == before + 1

    def test_reset_clears_accumulated_evidence(self):
        ctl = Controller(lo=1, hi=8, up_patience=2)
        assert ctl.step(4, +1) == 4
        ctl.reset()
        assert ctl.step(4, +1) == 4  # patience starts over after the reset
        assert ctl.step(4, +1) == 5


# -- delta ticker --------------------------------------------------------------


class TestDeltaTicker:
    def test_first_tick_seeds_and_interval_gates(self):
        clock = [100.0]
        reads = []

        def read():
            reads.append(clock[0])
            return (clock[0], clock[0] * 2)

        ticker = DeltaTicker(10.0, read, clock=lambda: clock[0])
        assert ticker.tick() is None  # baseline only
        clock[0] += 5.0
        assert ticker.tick() is None  # sub-interval: read not consulted
        assert len(reads) == 1
        clock[0] += 5.0
        deltas, elapsed = ticker.tick()
        assert deltas == (10.0, 20.0)
        assert elapsed == pytest.approx(10.0)


# -- cluster scaler ------------------------------------------------------------


class TestClusterScaler:
    def test_grow_needs_patience_across_intervals(self):
        scaler = ClusterScaler(4, min_size=1, grow_patience=2)
        assert scaler.decide(2, 4) == 2  # first healthy verdict: hold
        assert scaler.decide(2, 4) == 3  # second consecutive: one rung up

    def test_input_bound_defers_grow_and_clears_credit(self):
        scaler = ClusterScaler(4, min_size=1, grow_patience=2)
        assert scaler.decide(2, 4, "device_bound") == 2
        # an input-bound interval not only holds, it invalidates the
        # accumulated healthy verdict: the window starts over
        assert scaler.decide(2, 4, "io_bound") == 2
        assert scaler.decide(2, 4, "device_bound") == 2
        assert scaler.decide(2, 4, "device_bound") == 3

    def test_shrink_is_immediate(self):
        scaler = ClusterScaler(4, min_size=1, grow_patience=2)
        assert scaler.decide(3, 2) == 2
        # ...even when the interval was input-bound: the gate only guards
        # paying for growth
        assert scaler.decide(2, 1, "io_bound") == 1

    def test_bounds_and_gauge(self):
        scaler = ClusterScaler(3, min_size=2, grow_patience=1)
        assert scaler.decide(2, 1) == 2  # floor holds
        assert scaler.decide(3, 5) == 3  # ceiling clamps at full size
        scaler.observe(2)
        assert obs.snapshot()["gauges"]["target_world_size"]["value"] == 2

    def test_observe_resets_the_patience_window(self):
        scaler = ClusterScaler(4, min_size=1, grow_patience=2)
        assert scaler.decide(2, 4) == 2
        scaler.observe(2)  # the ladder imposed a size: regime change
        assert scaler.decide(2, 4) == 2
        assert scaler.decide(2, 4) == 3
