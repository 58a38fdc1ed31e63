"""The port's ``serving_mesh.py`` and the serving chaos sites on the CPU.

The cases of ``tests/test_serving_mesh.py``, ``tests/test_chaos_mesh.py``
and ``tests/test_chaos_serving.py`` re-run on the port: the model pointer
and its torn-publish reject, the replica's hot swap, the router
(round-robin, failover, circuit shed, hedging, the named final error), the
mesh lifecycle in thread mode (kill → lease expiry → relaunch under load,
hot swap under load, the ``mesh`` CLI with ``--metrics_port``) and in
process mode (forked replicas serve and survive a SIGKILL, the
``serving.replica_kill`` site), and the fork rule: with CUDA initialized in
the parent, a process-mode mesh refuses to fork. Bundles are the port's
(torch builders on ``TOS_PLATFORM=cpu``); a process-mode case bounds every
wait by its own deadline."""

import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu import serving_mesh as jserving_mesh
from tensorflowonspark_tpu_torch import chaos, obs, resilience, serving, util
from tensorflowonspark_tpu_torch.ckpt import manifest
from tensorflowonspark_tpu_torch.serving import InferenceClient, InferenceServer, Overloaded
from tensorflowonspark_tpu_torch.serving_mesh import (
    MeshFrontend,
    ModelPointer,
    ReplicaRouter,
    ReplicaServer,
    ServingMesh,
)
from tensorflowonspark_tpu_torch.train import export


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv(util.ENV_PLATFORM, "cpu")
    chaos.uninstall()
    yield
    chaos.uninstall()


def builder(device=None):
    dev = torch.device(device or "cuda")

    def predict(params, model_state, arrays):
        x = torch.as_tensor(np.asarray(arrays["x"], np.float32), device=dev)
        return {"y_": x @ torch.as_tensor(params["w"], device=dev)}

    return predict


def _params(scale):
    return {"w": np.full((1, 1), float(scale), np.float32)}


def _bundle(path, scale):
    export.export_model(str(path), builder, _params(scale))
    return str(path)


def _counter(name):
    return obs.snapshot()["counters"].get(name, {}).get("value", 0)


def _gauge(name):
    return obs.snapshot()["gauges"].get(name, {}).get("value", 0)


def _value(out):
    return float(np.asarray(out["y_"]).ravel()[0])


def _one():
    return np.ones((1, 1), np.float32)


def _fast_router(endpoints, **kw):
    kw.setdefault("deadline", 10.0)
    kw.setdefault("backoff", resilience.Backoff(base=0.02, factor=2.0, max_delay=0.1, jitter=0.5, seed=0))
    return ReplicaRouter(endpoints, **kw)


def _dead_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(cond, secs):
    deadline = time.time() + secs
    while time.time() < deadline and not cond():
        time.sleep(0.05)
    return cond()


# -- the model pointer and the replica's hot swap --------------------------------


class TestModelPointer:
    def test_publish_flips_pointer_atomically(self, tmp_path):
        pointer = ModelPointer(str(tmp_path / "ptr"))
        assert pointer.current() is None
        gen0 = pointer.publish(builder, _params(2))
        assert pointer.current() == ("gen-000000", gen0)
        assert manifest.verify(gen0)[0]
        gen1 = pointer.publish(builder, _params(5))
        assert pointer.generations() == ["gen-000000", "gen-000001"]
        assert pointer.current() == ("gen-000001", gen1)

    def test_publish_bundle_adopts_and_restamps(self, tmp_path):
        src = _bundle(tmp_path / "src", 3)
        manifest.write_manifest(src, step=7)
        gen0 = ModelPointer(str(tmp_path / "ptr")).publish_bundle(src, step=9)
        assert manifest.verify(gen0)[0]
        assert manifest.read_manifest(gen0)["extra"]["generation"] == "gen-000000"

    def test_the_jax_packages_pointer_reads_the_ports_generations(self, tmp_path):
        """The layout is the JAX package's: its ModelPointer sees the same
        generations and the same CURRENT."""
        pointer = ModelPointer(str(tmp_path / "ptr"))
        pointer.publish(builder, _params(2))
        pointer.publish(builder, _params(5))
        theirs = jserving_mesh.ModelPointer(pointer.root)
        assert theirs.generations() == pointer.generations()
        assert theirs.current() == pointer.current()

    def test_torn_publish_fails_cheap_verify(self, tmp_path):
        pointer = ModelPointer(str(tmp_path / "ptr"))
        plan = chaos.ChaosPlan(seed=0).site("serving.swap_torn", probability=1.0, max_count=1)
        chaos.install(plan, propagate=False)
        gen0 = pointer.publish(builder, _params(2))
        assert plan.fired("serving.swap_torn") == 1
        ok, reason = manifest.verify(gen0)
        assert not ok and reason


class TestReplicaServer:
    def test_hot_swap_serves_new_generation(self, tmp_path):
        pointer = ModelPointer(str(tmp_path / "ptr"))
        pointer.publish(builder, _params(2))
        rep = ReplicaServer(pointer.root, poll_interval=999)
        rep.start()
        client = InferenceClient(rep.address, timeout=30, retry=resilience.RetryPolicy(max_attempts=1))
        try:
            assert _value(client.predict_binary(x=_one())) == 2.0
            swaps = _counter("serving_swaps_total")
            pointer.publish(builder, _params(5))
            assert rep.check_swap() is True
            assert _counter("serving_swaps_total") - swaps == 1
            assert rep.generation() == "gen-000001"
            assert _value(client.predict_binary(x=_one())) == 5.0
            assert rep.check_swap() is False
            assert _counter("serving_swaps_total") - swaps == 1
        finally:
            client.close()
            rep.stop()

    def test_torn_swap_rejected_old_model_keeps_serving(self, tmp_path):
        pointer = ModelPointer(str(tmp_path / "ptr"))
        pointer.publish(builder, _params(2))
        rep = ReplicaServer(pointer.root, poll_interval=999)
        rep.start()
        client = InferenceClient(rep.address, timeout=30, retry=resilience.RetryPolicy(max_attempts=1))
        try:
            rejects = _counter("serving_swap_rejects_total")
            plan = chaos.ChaosPlan(seed=6).site("serving.swap_torn", probability=1.0, max_count=1)
            chaos.install(plan, propagate=False)
            pointer.publish(builder, _params(9))
            assert plan.fired("serving.swap_torn") == 1
            assert rep.check_swap() is False
            assert _counter("serving_swap_rejects_total") - rejects == 1
            assert rep.generation() == "gen-000000"
            assert _value(client.predict_binary(x=_one())) == 2.0
            assert rep.check_swap() is False  # remembered: no recount
            assert _counter("serving_swap_rejects_total") - rejects == 1
            chaos.uninstall()
            pointer.publish(builder, _params(7))
            assert rep.check_swap() is True
            assert _value(client.predict_binary(x=_one())) == 7.0
        finally:
            client.close()
            rep.stop()

    def test_stop_does_not_wait_out_the_swap_poll(self, tmp_path):
        """The watcher sleeps on the replica's stop event: stop() returns at
        once even with a long poll interval."""
        pointer = ModelPointer(str(tmp_path / "ptr"))
        pointer.publish(builder, _params(2))
        rep = ReplicaServer(pointer.root, poll_interval=999)
        rep.start()
        t0 = time.monotonic()
        rep.stop()
        assert time.monotonic() - t0 < 5.0
        assert not rep._watcher.is_alive()


# -- the router -------------------------------------------------------------------


class _SlowEcho(serving.ProtocolServer):
    def __init__(self, delay):
        self.delay = delay
        serving.ProtocolServer.__init__(self, host="127.0.0.1", port=0, name="tos-test-slow")

    def _submit(self, arrays):
        time.sleep(self.delay)
        return {"y_": np.full_like(np.asarray(arrays["x"]), 99.0)}


class TestReplicaRouter:
    @pytest.fixture
    def pair(self, tmp_path):
        a = InferenceServer(_bundle(tmp_path / "a", 1), host="127.0.0.1")
        b = InferenceServer(_bundle(tmp_path / "b", 2), host="127.0.0.1")
        a.start()
        b.start()
        yield a, b
        a.stop()
        b.stop()

    def test_round_robin_spreads_requests(self, pair):
        a, b = pair
        router = _fast_router({0: a.address, 1: b.address})
        try:
            assert {_value(router.predict_binary(x=_one())) for _ in range(4)} == {1.0, 2.0}
        finally:
            router.close()

    def test_failover_reroutes_around_dead_replica(self, pair):
        a, b = pair
        a.kill()
        failovers = _counter("serving_failovers_total")
        router = _fast_router({0: a.address, 1: b.address}, breaker_threshold=50)
        try:
            for _ in range(3):
                assert _value(router.predict_binary(x=_one())) == 2.0
            assert _counter("serving_failovers_total") - failovers >= 3
        finally:
            router.close()

    def test_partition_drives_failover_not_an_error(self, pair):
        plan = chaos.ChaosPlan(seed=4).site("serving.router_partition", probability=1.0, max_count=1)
        chaos.install(plan, propagate=False)
        failovers = _counter("serving_failovers_total")
        a, b = pair
        router = _fast_router({0: a.address, 1: b.address}, breaker_threshold=5)
        try:
            assert _value(router.predict_binary(x=_one())) in (1.0, 2.0)
            assert plan.fired("serving.router_partition") == 1
            assert _counter("serving_failovers_total") - failovers >= 1
        finally:
            router.close()

    def test_all_circuits_open_sheds_with_distinct_reason(self):
        eps = {0: ("127.0.0.1", _dead_port()), 1: ("127.0.0.1", _dead_port())}
        shed, trips = _counter("serving_mesh_shed_total"), _counter("serving_circuit_open_total")
        router = _fast_router(eps, breaker_threshold=1, breaker_reset=60.0)
        try:
            with pytest.raises(Overloaded, match="circuits open"):
                router.predict_binary(x=_one())
            assert _counter("serving_mesh_shed_total") - shed == 1
            assert _counter("serving_circuit_open_total") - trips == 2
        finally:
            router.close()

    def test_empty_mesh_sheds_immediately(self):
        shed = _counter("serving_mesh_shed_total")
        router = _fast_router({})
        try:
            with pytest.raises(Overloaded, match="no live replicas"):
                router.predict(x=[[1.0]])
            assert _counter("serving_mesh_shed_total") - shed == 1
        finally:
            router.close()

    def test_final_error_names_replicas_elapsed_and_budget(self):
        router = _fast_router({0: ("127.0.0.1", _dead_port())}, deadline=1.0, breaker_threshold=100)
        try:
            with pytest.raises(ConnectionError) as err:
                router.predict_binary(x=_one())
            msg = str(err.value)
            assert "replica(s) [0]" in msg and "1s budget" in msg and "after" in msg
        finally:
            router.close()

    def test_hedge_to_second_replica_wins(self, tmp_path):
        slow = _SlowEcho(delay=1.5)
        slow.start()
        fast = InferenceServer(_bundle(tmp_path / "fast", 4), host="127.0.0.1")
        fast.start()
        hedges = _counter("serving_hedges_total")
        router = _fast_router({0: slow.address, 1: fast.address}, hedge_after=0.15)
        try:
            assert _value(router.predict_binary(x=_one())) == 4.0
            assert _counter("serving_hedges_total") - hedges == 1
        finally:
            router.close()
            fast.stop()
            slow.stop()


# -- the mesh, thread mode -----------------------------------------------------


def _load(router, values, errors, stop, want=None):
    while not stop.is_set():
        try:
            v = _value(router.predict_binary(x=_one()))
            if want is not None and v != want:
                raise AssertionError("served {} not {}".format(v, want))
            values.append(v)
        except Exception as e:  # any client-visible failure is a bug
            errors.append(e)
        time.sleep(0.01)


class TestMeshThreadMode:
    def test_start_route_and_frontend(self, tmp_path):
        mesh = ServingMesh(_bundle(tmp_path / "bundle", 3), replicas=2, mode="thread", monitor_interval=0.5)
        mesh.start()
        router = mesh.router(deadline=10.0)
        front = MeshFrontend(router, host="127.0.0.1")
        front.start()
        client = InferenceClient(front.address, timeout=30)
        try:
            assert len(mesh.endpoints()) == 2
            assert _value(router.predict_binary(x=_one())) == 3.0
            assert _value(client.predict_binary(x=_one())) == 3.0
            assert client.info().get("mesh") is True
        finally:
            client.close()
            front.stop()
            router.close()
            mesh.stop()

    def test_kill_expires_lease_relaunches_and_requests_survive(self, tmp_path):
        mesh = ServingMesh(_bundle(tmp_path / "bundle", 3), replicas=2, mode="thread",
                           monitor_interval=0.2, lease_ttl=0.8)
        mesh.start()
        router = mesh.router(deadline=15.0)
        relaunches = _counter("serving_replica_relaunches_total")
        expiries = _counter("registry_lease_expirations_total")
        values, errors, stop = [], [], threading.Event()
        threads = [threading.Thread(target=_load, args=(router, values, errors, stop, 3.0)) for _ in range(3)]
        try:
            assert _wait(lambda: mesh._beats.get(0, 0) >= 1, 10)
            old_addr = mesh.endpoints()[0]
            for t in threads:
                t.start()
            assert mesh.kill_replica(0) == 0
            assert _wait(lambda: _counter("serving_replica_relaunches_total") - relaunches >= 1
                         and len(mesh.endpoints()) == 2, 30)
            time.sleep(0.3)
            stop.set()
            for t in threads:
                t.join(timeout=30)
            assert not errors, errors[:3]
            assert _counter("registry_lease_expirations_total") - expiries >= 1
            assert mesh.endpoints()[0] != old_addr
            assert _gauge("serving_replicas_active") == 2
        finally:
            stop.set()
            router.close()
            mesh.stop()

    def test_hot_swap_under_load_zero_failures(self, tmp_path):
        pointer = ModelPointer(str(tmp_path / "ptr"))
        pointer.publish(builder, _params(2))
        mesh = ServingMesh(pointer.root, replicas=2, mode="thread", monitor_interval=0.5, swap_poll=0.1)
        mesh.start()
        router = mesh.router(deadline=15.0)
        swaps, rejects = _counter("serving_swaps_total"), _counter("serving_swap_rejects_total")
        values, errors, stop = [], [], threading.Event()
        threads = [threading.Thread(target=_load, args=(router, values, errors, stop)) for _ in range(4)]
        try:
            for t in threads:
                t.start()
            time.sleep(0.3)
            pointer.publish(builder, _params(6))

            def flipped():
                with mesh._lock:
                    return all(rec.server.generation() == "gen-000001" for rec in mesh._replicas.values())

            assert _wait(flipped, 20)
            time.sleep(0.3)
            stop.set()
            for t in threads:
                t.join(timeout=30)
            assert not errors, errors[:3]
            assert set(values) <= {2.0, 6.0} and values[-1] == 6.0
            assert _counter("serving_swaps_total") - swaps == 2
            assert _counter("serving_swap_rejects_total") - rejects == 0
        finally:
            stop.set()
            router.close()
            mesh.stop()

    def test_replica_kill_chaos_site_relaunches(self, tmp_path):
        """``serving.replica_kill`` fires in the monitor loop; the killed
        replica is discovered and relaunched with no client-visible error."""
        mesh = ServingMesh(_bundle(tmp_path / "bundle", 3), replicas=3, mode="thread",
                           monitor_interval=0.2, lease_ttl=0.8)
        mesh.start()
        router = mesh.router(deadline=15.0)
        relaunches = _counter("serving_replica_relaunches_total")
        values, errors, stop = [], [], threading.Event()
        threads = [threading.Thread(target=_load, args=(router, values, errors, stop, 3.0)) for _ in range(3)]
        try:
            assert _wait(lambda: all(mesh._beats.get(r, 0) >= 1 for r in range(3)), 10)
            for t in threads:
                t.start()
            plan = chaos.ChaosPlan(seed=13).site("serving.replica_kill", probability=1.0, max_count=1)
            chaos.install(plan, propagate=False)
            assert _wait(lambda: _counter("serving_replica_relaunches_total") - relaunches >= 1
                         and len(mesh.endpoints()) == 3, 30)
            stop.set()
            for t in threads:
                t.join(timeout=30)
            assert plan.fired("serving.replica_kill") == 1
            assert not errors, errors[:3]
        finally:
            stop.set()
            router.close()
            mesh.stop()

    def test_cli_mesh_mode_scrape_shows_replica_gauge(self, tmp_path):
        bundle = _bundle(tmp_path / "bundle", 3)
        front_port, metrics_port = _dead_port(), _dead_port()
        t = threading.Thread(target=serving.main, args=(
            ["mesh", "--export_dir", bundle, "--replicas", "2", "--host", "127.0.0.1",
             "--port", str(front_port), "--metrics_port", str(metrics_port)],), daemon=True)
        t.start()
        try:
            body = [""]

            def scraped():
                try:
                    with urllib.request.urlopen("http://127.0.0.1:{}/metrics".format(metrics_port),
                                                timeout=5) as resp:
                        body[0] = resp.read().decode("utf-8")
                except OSError:
                    pass
                return "serving_replicas_active 2" in body[0]

            assert _wait(scraped, 60), body[0][-500:]
            client = InferenceClient(("127.0.0.1", front_port), timeout=30)
            try:
                assert client.info()["mesh"] is True
                assert _value(client.predict_binary(x=_one())) == 3.0
            finally:
                client.close()
        finally:
            _wait(lambda: serving._exit_event is not None, 10)
            if serving._exit_event is not None:
                serving._exit_event.set()
            t.join(timeout=60)
        assert not t.is_alive(), "mesh CLI did not shut down"


# -- the mesh, process mode ----------------------------------------------------


class TestMeshProcessMode:
    def test_process_replicas_serve_and_survive_sigkill(self, tmp_path):
        """Forked replicas (torch on the CPU lane) serve; a SIGKILLed child
        is discovered, its lease expires, and the slot relaunches."""
        mesh = ServingMesh(_bundle(tmp_path / "bundle", 5), replicas=2, mode="process",
                           monitor_interval=0.3, lease_ttl=1.0, spawn_timeout=30.0)
        mesh.start()
        router = mesh.router(deadline=20.0)
        relaunches = _counter("serving_replica_relaunches_total")
        try:
            assert _value(router.predict_binary(x=_one())) == 5.0
            with mesh._lock:
                pid = mesh._replicas[0].proc.pid
            assert mesh.kill_replica(0) == 0
            deadline = time.time() + 60
            while time.time() < deadline and _counter("serving_replica_relaunches_total") - relaunches < 1:
                assert _value(router.predict_binary(x=_one())) == 5.0
                time.sleep(0.2)
            assert _counter("serving_replica_relaunches_total") - relaunches >= 1
            with mesh._lock:
                assert mesh._replicas[0].proc.pid != pid
            assert _value(router.predict_binary(x=_one())) == 5.0
        finally:
            router.close()
            mesh.stop()

    def test_process_replicas_hot_swap(self, tmp_path):
        pointer = ModelPointer(str(tmp_path / "ptr"))
        pointer.publish(builder, _params(2))
        mesh = ServingMesh(pointer.root, replicas=2, mode="process", monitor_interval=0.5,
                           swap_poll=0.1, spawn_timeout=30.0)
        mesh.start()
        router = mesh.router(deadline=20.0)
        try:
            assert _value(router.predict_binary(x=_one())) == 2.0
            pointer.publish(builder, _params(6))
            assert _wait(lambda: all(_value(router.predict_binary(x=_one())) == 6.0 for _ in range(6)), 30)
        finally:
            router.close()
            mesh.stop()

    def test_fork_with_cuda_initialized_is_refused(self, tmp_path, monkeypatch):
        """A replica forked after CUDA is up cannot use the card: the mesh
        raises before forking, and does not switch to another start method."""
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        mesh = ServingMesh(_bundle(tmp_path / "bundle", 1), replicas=1, mode="process")
        with pytest.raises(RuntimeError, match="CUDA is initialized"):
            mesh.start()
        assert mesh.endpoints() == {}
        mesh.stop()

    def test_thread_mode_does_not_consult_cuda(self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        mesh = ServingMesh(_bundle(tmp_path / "bundle", 1), replicas=1, mode="thread")
        mesh.start()
        try:
            assert len(mesh.endpoints()) == 1
        finally:
            mesh.stop()


# -- tests/test_chaos_serving.py on the port -------------------------------------


@pytest.fixture
def server(tmp_path):
    srv = InferenceServer(_bundle(tmp_path / "bundle", 3), host="127.0.0.1")
    srv.start()
    yield srv
    srv.stop()


def _fast_client(server, attempts=3):
    return InferenceClient(server.address, timeout=30, retry=resilience.RetryPolicy(
        max_attempts=attempts,
        backoff=resilience.Backoff(base=0.02, factor=2.0, max_delay=0.1, jitter=0.5, seed=0),
        retry_on=(OSError, Overloaded), name="inference-client"))


class TestServingChaos:
    def test_injected_latency_only_slows_the_answer(self, server):
        plan = chaos.ChaosPlan(seed=0).site("serving.latency", probability=1.0, max_count=2, delay_s=0.05)
        chaos.install(plan, propagate=False)
        client = _fast_client(server)
        try:
            assert client.predict(x=[[2.0]]) == {"y_": [[6.0]]}
        finally:
            client.close()
        assert plan.fired("serving.latency") >= 1

    def test_client_redials_through_dropped_connections(self, server):
        plan = chaos.ChaosPlan(seed=1).site("serving.conn_drop", probability=1.0, max_count=2)
        chaos.install(plan, propagate=False)
        client = _fast_client(server)
        try:
            assert client.predict(x=[[2.0]]) == {"y_": [[6.0]]}
            assert _value(client.predict_binary(x=_one())) == 3.0
        finally:
            client.close()
        assert plan.fired("serving.conn_drop") == 2
        assert _counter("chaos_fault_serving_conn_drop_total") >= 2

    def test_client_backs_off_through_transient_overload(self, server):
        plan = chaos.ChaosPlan(seed=3).site("serving.overload", probability=1.0, max_count=2)
        chaos.install(plan, propagate=False)
        shed = _counter("serving_shed_overloaded_total")
        client = _fast_client(server)
        try:
            assert client.predict(x=[[2.0]]) == {"y_": [[6.0]]}
        finally:
            client.close()
        assert plan.fired("serving.overload") == 2
        assert _counter("serving_shed_overloaded_total") - shed == 2

    def test_fail_fast_client_surfaces_overload(self, server):
        chaos.install(chaos.ChaosPlan(seed=3).site("serving.overload", probability=1.0), propagate=False)
        client = _fast_client(server, attempts=1)
        try:
            with pytest.raises(Overloaded):
                client.predict(x=[[2.0]])
        finally:
            client.close()

    def test_pending_counter_returns_to_zero(self):
        pred = serving._Predictor(lambda p, ms, a: {"y": a["x"]}, None, None, max_pending=4)
        try:
            for _ in range(3):
                pred.submit({"x": np.ones((2, 2), np.float32)})
            assert pred._pending == 0
        finally:
            pred.stop()

    def test_single_slot_rejects_concurrent_second_request(self):
        release = threading.Event()

        def slow_fn(params, model_state, arrays):
            release.wait(30)
            return {"y": arrays["x"]}

        pred = serving._Predictor(slow_fn, None, None, max_pending=1)
        try:
            results = []
            t = threading.Thread(target=lambda: results.append(pred.submit({"x": np.ones((1, 2), np.float32)})))
            t.start()
            time.sleep(0.4)
            with pytest.raises(Overloaded):
                pred.submit({"x": np.ones((1, 2), np.float32)})
            release.set()
            t.join(timeout=30)
            assert len(results) == 1 and pred._pending == 0
        finally:
            release.set()
            pred.stop()
