"""The chaos subsystem itself: plan determinism under a seed, per-site
probability/count budgets, env-var propagation, obs visibility of injected
faults, and the zero-overhead disabled path."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from tensorflowonspark_tpu_torch import chaos, obs


@pytest.fixture(autouse=True)
def _clean_chaos():
    """Every test starts and ends with no plan installed (chaos state is
    process-global, like the obs registry)."""
    chaos.uninstall()
    yield
    chaos.uninstall()


class TestChaosPlan:
    def test_same_seed_same_schedule(self):
        def schedule(seed):
            plan = chaos.ChaosPlan(seed=seed).site("x.y", probability=0.5)
            return [plan.should_fire("x.y") is not None for _ in range(50)]

        assert schedule(7) == schedule(7)
        assert schedule(7) != schedule(8)

    def test_sites_draw_independent_rngs(self):
        # site A's schedule must not depend on how often site B is polled
        plan1 = chaos.ChaosPlan(seed=3).site("a", probability=0.5).site("b", probability=0.5)
        plan2 = chaos.ChaosPlan(seed=3).site("a", probability=0.5).site("b", probability=0.5)
        seq1 = []
        for i in range(30):
            plan1.should_fire("b")  # interleaved polls of the other site
            seq1.append(plan1.should_fire("a") is not None)
        seq2 = [plan2.should_fire("a") is not None for _ in range(30)]
        assert seq1 == seq2

    def test_max_count_budget(self):
        plan = chaos.ChaosPlan(seed=0).site("s", probability=1.0, max_count=3)
        fires = [plan.should_fire("s") for _ in range(10)]
        assert sum(1 for f in fires if f) == 3
        assert plan.fired("s") == 3
        assert plan.fired() == 3

    def test_probability_zero_never_fires(self):
        plan = chaos.ChaosPlan(seed=0).site("s", probability=0.0)
        assert all(plan.should_fire("s") is None for _ in range(100))

    def test_unknown_site_never_fires(self):
        plan = chaos.ChaosPlan(seed=0).site("s", probability=1.0)
        assert plan.should_fire("other") is None

    def test_json_roundtrip_preserves_schedule(self):
        plan = chaos.ChaosPlan(seed=11).site("s", probability=0.4, max_count=5, delay_s=0.2)
        clone = chaos.ChaosPlan.from_json(plan.to_json())
        assert clone.seed == plan.seed
        assert clone.sites == plan.sites
        a = [plan.should_fire("s") is not None for _ in range(40)]
        b = [clone.should_fire("s") is not None for _ in range(40)]
        assert a == b

    def test_rejects_bad_probability(self):
        with pytest.raises(ValueError):
            chaos.ChaosPlan().site("s", probability=1.5)


class TestInstall:
    def test_install_sets_active_and_env(self):
        assert not chaos.active
        plan = chaos.ChaosPlan(seed=1).site("s", probability=1.0)
        chaos.install(plan)
        assert chaos.active
        assert chaos.plan() is plan
        assert json.loads(os.environ[chaos.ENV_VAR])["seed"] == 1
        chaos.uninstall()
        assert not chaos.active
        assert chaos.ENV_VAR not in os.environ

    def test_install_without_propagation(self):
        chaos.install(chaos.ChaosPlan(seed=2), propagate=False)
        assert chaos.active
        assert chaos.ENV_VAR not in os.environ

    def test_child_process_inherits_plan_from_env(self):
        """The subprocess-propagation lane: a spawned interpreter re-installs
        the plan at import and fires the same deterministic schedule."""
        plan = chaos.ChaosPlan(seed=9).site("s", probability=0.5)
        parent = [plan.should_fire("s") is not None for _ in range(20)]
        code = textwrap.dedent(
            """
            from tensorflowonspark_tpu_torch import chaos
            assert chaos.active, "plan not installed from env"
            p = chaos.plan()
            print([p.should_fire("s") is not None for _ in range(20)])
            """
        )
        pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(chaos.__file__)))
        repo_root = os.path.dirname(pkg_dir)
        env = dict(os.environ, TOS_PLATFORM="cpu", PYTHONPATH=repo_root)
        env[chaos.ENV_VAR] = plan.to_json()
        out = subprocess.run(
            [sys.executable, "-c", code],
            env=env, cwd=repo_root, capture_output=True, text=True,
        )
        assert out.returncode == 0, out.stderr
        assert eval(out.stdout.strip()) == parent

    def test_malformed_env_plan_is_ignored(self):
        os.environ[chaos.ENV_VAR] = "{not json"
        try:
            chaos._install_from_env()  # must not raise
            assert not chaos.active
        finally:
            os.environ.pop(chaos.ENV_VAR, None)


class TestFire:
    def test_fire_records_obs_counters_and_span(self):
        chaos.install(chaos.ChaosPlan(seed=0).site("unit.test_site", probability=1.0))
        before = obs.snapshot()["counters"].get("chaos_faults_injected_total", {}).get("value", 0)
        assert chaos.fire("unit.test_site") is not None
        snap = obs.snapshot()
        assert snap["counters"]["chaos_faults_injected_total"]["value"] == before + 1
        assert snap["counters"]["chaos_fault_unit_test_site_total"]["value"] >= 1
        assert any(
            e.get("span") == "chaos_fault" and e.get("site") == "unit.test_site"
            for e in snap["events"]
        )

    def test_fire_disabled_returns_none(self):
        assert chaos.fire("anything") is None

    def test_delay_sleeps_only_when_triggered(self):
        chaos.install(chaos.ChaosPlan(seed=0).site("d", probability=1.0, delay_s=0.0))
        assert chaos.delay("d") is True
        assert chaos.delay("not_a_site") is False

    def test_fire_appends_to_chaos_log(self, tmp_path, monkeypatch):
        log = tmp_path / "chaos.log"
        monkeypatch.setenv(chaos.LOG_ENV_VAR, str(log))
        chaos.install(chaos.ChaosPlan(seed=0).site("logged.site", probability=1.0))
        chaos.fire("logged.site")
        chaos.fire("logged.site")
        assert log.read_text().splitlines() == ["logged.site", "logged.site"]


class TestDisabledOverhead:
    def test_disabled_guard_allocates_nothing(self):
        """The acceptance bar: with chaos disabled a site costs one cached
        boolean check — no allocation, no call into the plan machinery."""
        assert not chaos.active
        for _ in range(10):  # warm attribute caches
            if chaos.active:
                chaos.fire("never")
        before = sys.getallocatedblocks()
        for _ in range(1000):
            if chaos.active:
                chaos.fire("never")
        grown = sys.getallocatedblocks() - before
        # zero in practice; tolerate interpreter-internal noise (same bound
        # as the disabled obs-registry test) — 1000 iterations of real
        # allocation would show thousands of blocks
        assert grown < 50, "disabled chaos guard allocated {} blocks".format(grown)

    def test_disabled_guard_never_reaches_fire(self, monkeypatch):
        def explode(site):
            raise AssertionError("fire() reached with chaos disabled")

        monkeypatch.setattr(chaos, "fire", explode)
        if chaos.active:  # the exact guard every injection site uses
            chaos.fire("never")
