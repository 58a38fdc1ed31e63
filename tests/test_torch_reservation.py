"""Control-plane tests, cluster-free (mirrors reference test/test_reservation.py)."""

import os
import threading
import time
from unittest import mock

import pytest

from tensorflowonspark_tpu_torch import reservation, resilience


class TestReservations:
    def test_counting(self):
        store = reservation.Reservations(3)
        assert store.remaining() == 3
        assert not store.done
        store.add({"node": 0})
        store.add({"node": 1})
        assert store.remaining() == 1
        store.add({"node": 2})
        assert store.done
        assert len(store.get()) == 3

    def test_wait_timeout(self):
        store = reservation.Reservations(1)
        assert not store.wait(timeout=0.1)
        store.add({"node": 0})
        assert store.wait(timeout=0.1)


class TestServerClient:
    def test_register_query_info_stop(self):
        server = reservation.Server(2)
        addr = server.start()
        try:
            client = reservation.Client(addr)
            assert client.get_reservations() == []
            client.register({"host": "a", "executor_id": 0})
            client.register({"host": "b", "executor_id": 1})
            info = client.await_reservations(timeout=5)
            assert {r["host"] for r in info} == {"a", "b"}
            assert not client.stop_requested()
            client.request_stop()
            assert client.stop_requested()
            assert server.stop_requested
        finally:
            server.stop()

    def test_driver_await_aborts_on_node_error(self):
        server = reservation.Server(2)
        server.start()
        try:
            status = {}

            def fail_soon():
                time.sleep(0.2)
                status["error"] = "boom on executor 1"

            threading.Thread(target=fail_soon, daemon=True).start()
            with pytest.raises(reservation.ReservationError, match="boom"):
                server.await_reservations(status=status, timeout=10, poll_interval=0.05)
        finally:
            server.stop()

    def test_driver_await_times_out(self):
        server = reservation.Server(2)
        server.start()
        try:
            with pytest.raises(reservation.ReservationError, match="timed out"):
                server.await_reservations(timeout=0.3, poll_interval=0.05)
        finally:
            server.stop()

    def test_env_overrides(self):
        with mock.patch.dict(os.environ, {reservation.ENV_SERVER_HOST: "visible.example"}):
            server = reservation.Server(1)
            host, port = server.start()
            try:
                assert host == "visible.example"
                assert port > 0
            finally:
                server.stop()

    def test_concurrent_clients(self):
        n = 4
        server = reservation.Server(n)
        addr = server.start()
        try:
            def reserve(i):
                c = reservation.Client(addr)
                c.register({"executor_id": i})
                c.await_reservations(timeout=10, poll_interval=0.05)

            threads = [threading.Thread(target=reserve, args=(i,)) for i in range(n)]
            for t in threads:
                t.start()
            got = server.await_reservations(timeout=10, poll_interval=0.05)
            for t in threads:
                t.join(timeout=10)
            assert sorted(r["executor_id"] for r in got) == list(range(n))
        finally:
            server.stop()


class TestDriverRestartWindow:
    """Connection-refused during a driver restart is
    retried under a deadline-bounded policy instead of failing fast."""

    FAST = resilience.Backoff(base=0.05, factor=1.0, max_delay=0.05, jitter=0.0)

    @staticmethod
    def _free_port():
        import socket as _socket

        s = _socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    def test_client_rides_out_a_driver_restart(self):
        port = self._free_port()  # nothing listening yet: connection refused
        client = reservation.Client(
            ("127.0.0.1", port), restart_window=20, backoff=self.FAST
        )
        result = {}

        def register():
            client.register({"executor_id": 0})
            result["reservations"] = client.await_reservations(
                timeout=20, poll_interval=0.05
            )

        t = threading.Thread(target=register, daemon=True)
        t.start()
        time.sleep(0.4)  # let the client knock on the closed port a few times
        with mock.patch.dict(os.environ, {reservation.ENV_SERVER_PORT: str(port)}):
            server = reservation.Server(1)
            server.start()  # the "restarted driver" comes back on the same addr
        try:
            t.join(timeout=20)
            assert not t.is_alive()
            assert result["reservations"][0]["executor_id"] == 0
        finally:
            server.stop()

    def test_window_exhaustion_names_address_and_budget(self):
        port = self._free_port()
        client = reservation.Client(
            ("127.0.0.1", port), restart_window=0.3, backoff=self.FAST
        )
        started = time.monotonic()
        with pytest.raises(reservation.ReservationError) as exc_info:
            client.register({"executor_id": 0})
        msg = str(exc_info.value)
        assert "127.0.0.1:{}".format(port) in msg
        assert "connection-refused retries" in msg
        assert "driver restart window 0s" in msg or "restart window" in msg
        assert time.monotonic() - started < 10  # bounded by the window, not RETRIES*backoff


class TestIdempotentRegister:
    def test_duplicate_executor_id_replaces(self):
        store = reservation.Reservations(2)
        store.add({"executor_id": 0, "v": 1})
        store.add({"executor_id": 0, "v": 2})  # retried REG
        assert not store.done
        assert store.get() == [{"executor_id": 0, "v": 2}]
        store.add({"executor_id": 1, "v": 1})
        assert store.done

    def test_non_object_json_does_not_kill_server(self):
        import socket as _socket
        import struct as _struct

        server = reservation.Server(1)
        _host, port = server.start()
        try:
            payload = b"123"
            with _socket.create_connection(("127.0.0.1", port)) as s:
                s.sendall(_struct.pack(">I", len(payload)) + payload)
            c = reservation.Client(("127.0.0.1", port))
            c.register({"executor_id": 0})
            assert server.reservations.done
        finally:
            server.stop()
