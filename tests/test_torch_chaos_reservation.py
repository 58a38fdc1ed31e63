"""Chaos: the reservation control plane assembles despite injected faults —
dropped registrations (server closes before replying), client-side
connection resets, slow accepts and late registrations — because REG is
idempotent and the client's shared retry policy re-registers."""

import threading

import pytest

from tensorflowonspark_tpu_torch import chaos, obs, reservation, resilience

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.uninstall()
    yield
    chaos.uninstall()


@pytest.fixture(autouse=True)
def _fast_retries(monkeypatch):
    """Keep retry sleeps in the millisecond range for the test."""
    monkeypatch.setattr(
        reservation.Client, "BACKOFF",
        resilience.Backoff(base=0.02, factor=2.0, max_delay=0.1, jitter=0.5, seed=0),
    )


def _counter(name):
    return obs.snapshot()["counters"].get(name, {}).get("value", 0)


class TestReservationChaos:
    def test_cluster_assembles_despite_dropped_registrations(self):
        plan = chaos.ChaosPlan(seed=5).site(
            "reservation.reg_drop", probability=1.0, max_count=2
        )
        chaos.install(plan, propagate=False)
        retries_before = _counter("reservation_client_retries_total")
        server = reservation.Server(3)
        addr = server.start()
        try:
            clients = [reservation.Client(addr, timeout=5) for _ in range(3)]
            threads = [
                threading.Thread(target=c.register, args=({"host": "h", "executor_id": i},))
                for i, c in enumerate(clients)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            info = server.await_reservations(timeout=30)
            assert {r["executor_id"] for r in info} == {0, 1, 2}
        finally:
            server.stop()
        # both faults fired and every one forced a client retry
        assert plan.fired("reservation.reg_drop") == 2
        assert _counter("reservation_client_retries_total") >= retries_before + 2
        assert _counter("chaos_fault_reservation_reg_drop_total") >= 2

    def test_client_survives_injected_connection_resets(self):
        plan = chaos.ChaosPlan(seed=1).site(
            "reservation.client_reset", probability=1.0, max_count=2
        )
        chaos.install(plan, propagate=False)
        server = reservation.Server(1)
        addr = server.start()
        try:
            client = reservation.Client(addr, timeout=5)
            client.register({"host": "a", "executor_id": 0})  # eats both resets
            assert client.await_reservations(timeout=10)
        finally:
            server.stop()
        assert plan.fired("reservation.client_reset") == 2

    def test_reset_budget_beyond_retries_surfaces_reservation_error(self):
        # more resets than the retry budget: the client gives up cleanly
        plan = chaos.ChaosPlan(seed=1).site("reservation.client_reset", probability=1.0)
        chaos.install(plan, propagate=False)
        server = reservation.Server(1)
        addr = server.start()
        try:
            client = reservation.Client(addr, timeout=5)
            with pytest.raises(reservation.ReservationError, match="could not reach"):
                client.register({"host": "a", "executor_id": 0})
        finally:
            server.stop()
        assert plan.fired("reservation.client_reset") == reservation.Client.RETRIES

    def test_slow_accept_and_late_register_only_delay(self):
        plan = (
            chaos.ChaosPlan(seed=2)
            .site("reservation.slow_accept", probability=1.0, max_count=2, delay_s=0.05)
            .site("reservation.late_register", probability=1.0, max_count=1, delay_s=0.05)
        )
        chaos.install(plan, propagate=False)
        server = reservation.Server(1)
        addr = server.start()
        try:
            client = reservation.Client(addr, timeout=5)
            client.register({"host": "a", "executor_id": 0})
            assert client.await_reservations(timeout=10)
        finally:
            server.stop()
        assert plan.fired("reservation.slow_accept") >= 1
        assert plan.fired("reservation.late_register") == 1
