"""Driver-hosted reservation / coordination control plane.

TPU-native re-design of the reference's reservation protocol
(/root/reference/tensorflowonspark/reservation.py). Same capability — every
executor registers exactly one reservation, the driver blocks until the cluster
is fully assembled, clients can fetch the final cluster info and request an
early stop — with deliberate differences:

* Wire format is length-prefixed **JSON**, not pickle: executors should not be
  able to execute arbitrary code on the driver via the control socket
  (reference framing: reservation.py:68-97).
* Reservations carry TPU topology (local chip count, process index hints) and
  the assembled cluster info is the input to ``jax.distributed.initialize`` —
  the server is the natural coordinator-election point (SURVEY.md §2.8).
* The store uses a condition variable instead of busy-polling where possible,
  but the driver-side ``await_reservations`` still polls with a timeout so it
  can abort on executor errors reported out-of-band (reference
  reservation.py:113-126).

Environment overrides ``TOS_TPU_SERVER_HOST`` / ``TOS_TPU_SERVER_PORT`` mirror
the reference's ``TFOS_SERVER_HOST/PORT`` (reservation.py:25-26) for NAT'd or
proxied driver setups.
"""

import json
import logging
import os
import selectors
import socket
import struct
import threading
import time

from tensorflowonspark_tpu_torch import chaos, obs, resilience
from tensorflowonspark_tpu_torch.obs import tracing

logger = logging.getLogger(__name__)

#: env var: externally-visible host for the server (NAT / container setups)
ENV_SERVER_HOST = "TOS_TPU_SERVER_HOST"
#: env var: fixed listening port for the server
ENV_SERVER_PORT = "TOS_TPU_SERVER_PORT"

_HEADER = struct.Struct(">I")
_MAX_MSG = 64 * 1024 * 1024


class ReservationError(Exception):
    """Raised when the cluster cannot be assembled (timeout or node error).

    ``missing`` carries the executor ids that never registered (when the
    server was told which ids to expect) — the recovery ladder's attribution
    input (:mod:`~tensorflowonspark_tpu_torch.elastic`).
    """

    def __init__(self, message, missing=None):
        super().__init__(message)
        self.missing = list(missing) if missing else []


class Reservations:
    """Thread-safe store of node reservations (reference reservation.py:31-65).

    ``required`` is the number of reservations that completes the cluster.
    ``expected_ids`` optionally names the executor ids that should arrive, so
    a timeout can report *which* nodes never registered instead of just how
    many.
    """

    def __init__(self, required, expected_ids=None):
        self.required = required
        self.expected_ids = sorted(expected_ids) if expected_ids else None
        self._lock = threading.Condition()
        self._entries = []

    def missing(self):
        """Expected executor ids that have not registered yet (sorted).

        Empty when no ``expected_ids`` were declared — the caller falls back
        to count-based reporting.
        """
        if self.expected_ids is None:
            return []
        with self._lock:
            seen = {
                e.get("executor_id") for e in self._entries if isinstance(e, dict)
            }
        return [eid for eid in self.expected_ids if eid not in seen]

    def add(self, meta):
        """Add (or idempotently replace) one reservation.

        Dedup key: ``executor_id`` when present. Spark retries tasks and the
        client retries lost replies, so REG must be idempotent — the reference
        handled retried tasks by reusing prior reservations
        (TFSparkNode.py:240-249); we dedup at the store instead.
        """
        with self._lock:
            key = meta.get("executor_id") if isinstance(meta, dict) else None
            if key is not None:
                for i, existing in enumerate(self._entries):
                    if isinstance(existing, dict) and existing.get("executor_id") == key:
                        self._entries[i] = meta
                        self._lock.notify_all()
                        return
            self._entries.append(meta)
            if self.done:
                self._lock.notify_all()

    def get(self):
        with self._lock:
            return list(self._entries)

    def remaining(self):
        with self._lock:
            return self.required - len(self._entries)

    @property
    def done(self):
        return len(self._entries) >= self.required

    def wait(self, timeout=None):
        """Block until complete; returns True if complete."""
        deadline = None if timeout is None else time.time() + timeout
        with self._lock:
            while not self.done:
                remaining = None if deadline is None else deadline - time.time()
                if remaining is not None and remaining <= 0:
                    return False
                self._lock.wait(timeout=remaining)
            return True


class MessageSocket:
    """Length-prefixed JSON framing over a stream socket."""

    def __init__(self, sock):
        self.sock = sock

    def send(self, obj):
        payload = json.dumps(obj).encode("utf-8")
        self.sock.sendall(_HEADER.pack(len(payload)) + payload)

    def recv(self):
        header = self._recv_exact(_HEADER.size)
        if header is None:
            return None
        (length,) = _HEADER.unpack(header)
        if length > _MAX_MSG:
            raise ReservationError("control message too large: {} bytes".format(length))
        payload = self._recv_exact(length)
        if payload is None:
            return None
        return json.loads(payload.decode("utf-8"))

    # raw frames (binary payload lanes, e.g. serving tensors) share the same
    # 4-byte BE length framing so one implementation owns the wire format

    def send_raw(self, payload):
        self.sock.sendall(_HEADER.pack(len(payload)) + payload)

    def recv_raw(self, max_bytes=None):
        """One raw frame. Oversize frames are consumed-and-refused (the
        stream stays in sync for the next message) — callers get a
        ValueError they can answer with an error reply."""
        header = self._recv_exact(_HEADER.size)
        if header is None:
            return None
        (length,) = _HEADER.unpack(header)
        if length < 0:
            raise ConnectionError("corrupt raw frame length {}".format(length))
        limit = _MAX_MSG if max_bytes is None else max_bytes
        if length > limit:
            remaining = length
            while remaining:
                chunk = self.sock.recv(min(1 << 20, remaining))
                if not chunk:
                    return None
                remaining -= len(chunk)
            raise ValueError(
                "raw frame too large: {} bytes (limit {})".format(length, limit)
            )
        return self._recv_exact(length)

    def _recv_exact(self, n):
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                return None
            buf.extend(chunk)
        return bytes(buf)

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class Server:
    """Reservation server hosted on the Spark driver.

    One instance per cluster. ``start()`` spawns a daemon listener thread
    multiplexing all executor clients with a selector (reference ran a
    select()-loop thread, reservation.py:148-188).

    ``expected_ids`` names the executor ids that should register (enables
    per-id timeout attribution via :meth:`Reservations.missing`);
    ``blacklist`` is a set of executor ids whose registrations are refused —
    the recovery ladder excludes known-bad hosts this way, and a refused
    executor fails fast instead of silently joining the wrong cluster.

    ``registry`` is an optional
    :class:`~tensorflowonspark_tpu_torch.registry.MembershipRegistry`: when given,
    it becomes the membership truth — its blacklist is consulted alongside
    (union with) the static ``blacklist`` set, and every accepted REG grants
    the executor a lease via ``registry.join``.
    """

    def __init__(self, count, expected_ids=None, blacklist=None, registry=None):
        if count <= 0:
            raise ValueError("reservation count must be positive")
        self.reservations = Reservations(count, expected_ids=expected_ids)
        self.blacklist = frozenset(blacklist or ())
        self.registry = registry
        self._stop_requested = threading.Event()
        self._shutdown = threading.Event()
        self._sock = None
        self._thread = None

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        """Bind, listen and serve in a daemon thread. Returns (host, port)."""
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        port = int(os.environ.get(ENV_SERVER_PORT, "0"))
        self._sock.bind(("", port))
        self._sock.listen(64)
        self._thread = threading.Thread(
            target=self._serve, name="tos-reservation-server", daemon=True
        )
        self._thread.start()
        host = os.environ.get(ENV_SERVER_HOST)
        if not host:
            from tensorflowonspark_tpu_torch import util

            host = util.get_ip_address()
        addr = (host, self._sock.getsockname()[1])
        logger.info("reservation server listening at %s", addr)
        return addr

    def stop(self):
        self._shutdown.set()
        # connect to ourselves to wake the selector promptly
        try:
            with socket.create_connection(
                ("127.0.0.1", self._sock.getsockname()[1]), timeout=1
            ):
                pass
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def stop_requested(self):
        """True once any client sent STOP (early-termination request)."""
        return self._stop_requested.is_set()

    # -- driver-side wait ----------------------------------------------------

    def await_reservations(self, status=None, timeout=600, poll_interval=1.0):
        """Block the driver until all nodes reserved.

        ``status`` is a shared dict the background launch thread writes an
        ``'error'`` key into when an executor fails during startup; we abort
        immediately in that case (reference reservation.py:113-126 +
        TFCluster.py:314-331).
        """
        pending = obs.gauge(
            "reservation_pending_nodes", help="nodes still missing from the cluster"
        )
        deadline = time.time() + timeout
        with obs.span("reservation_roundtrip", required=self.reservations.required):
            while not self.reservations.done:
                pending.set(self.reservations.remaining())
                if status and status.get("error"):
                    obs.counter(
                        "reservation_failures_total",
                        help="await_reservations aborts (node error or timeout)",
                    ).inc()
                    raise ReservationError(
                        "cluster startup aborted by node failure: {}".format(status["error"])
                    )
                if time.time() > deadline:
                    obs.counter("reservation_failures_total").inc()
                    missing = self.reservations.missing()
                    detail = (
                        "; never registered: executors {}".format(missing)
                        if missing
                        else ""
                    )
                    raise ReservationError(
                        "timed out waiting for {} node(s) to register (of {}){}".format(
                            self.reservations.remaining(),
                            self.reservations.required,
                            detail,
                        ),
                        missing=missing,
                    )
                self.reservations.wait(timeout=poll_interval)
        pending.set(0)
        logger.info(
            "all %d node(s) reserved", self.reservations.required
        )
        return self.reservations.get()

    # -- server internals ----------------------------------------------------

    def _serve(self):
        sel = selectors.DefaultSelector()
        sel.register(self._sock, selectors.EVENT_READ, data=None)
        try:
            while not self._shutdown.is_set():
                for key, _ in sel.select(timeout=0.5):
                    if key.data is None:
                        try:
                            conn, _addr = self._sock.accept()
                        except OSError:
                            continue
                        if chaos.active:
                            chaos.delay("reservation.slow_accept")
                        # bounded blocking reads: a stalled client must not
                        # wedge the single-threaded control plane
                        conn.settimeout(10.0)
                        sel.register(conn, selectors.EVENT_READ, data=MessageSocket(conn))
                    else:
                        msock = key.data
                        try:
                            msg = msock.recv()
                        except (OSError, ValueError, ReservationError):
                            msg = None
                        if msg is None:
                            sel.unregister(msock.sock)
                            msock.close()
                            continue
                        try:
                            self._handle(msock, msg)
                        except OSError:
                            sel.unregister(msock.sock)
                            msock.close()
                        except Exception as e:  # malformed-but-valid-JSON input
                            logger.warning("dropping bad control message %r: %s", msg, e)
                            sel.unregister(msock.sock)
                            msock.close()
        finally:
            for key in list(sel.get_map().values()):
                if key.data is not None:
                    key.data.close()
            sel.close()
            try:
                self._sock.close()
            except OSError:
                pass

    def _handle(self, msock, msg):
        """Dispatch one control message (reference reservation.py:130-146)."""
        kind = msg.get("type") if isinstance(msg, dict) else None
        if kind == "REG":
            if chaos.active and chaos.fire("reservation.reg_drop"):
                # drop the connection before replying: the client sees a
                # closed stream and re-registers (REG is idempotent)
                raise OSError("chaos: dropped registration")
            data = msg.get("data", {})
            eid = data.get("executor_id") if isinstance(data, dict) else None
            refused = eid is not None and (
                eid in self.blacklist
                or (self.registry is not None and self.registry.is_blacklisted(eid))
            )
            if refused:
                obs.counter(
                    "reservation_blacklist_rejections_total",
                    help="REG refused because the executor is blacklisted",
                ).inc()
                logger.warning("refusing registration from blacklisted executor %s", eid)
                msock.send(
                    {"type": "ERROR", "data": "executor {} is blacklisted".format(eid)}
                )
                return
            self.reservations.add(data)
            if self.registry is not None and eid is not None:
                try:
                    self.registry.join(
                        eid,
                        job_name=data.get("job_name"),
                        task_index=data.get("task_index"),
                    )
                except Exception as e:
                    # a fenced/failed journal must not take down assembly:
                    # the lease is advisory until the watchdog reads it
                    logger.warning("registry join for executor %s failed: %s", eid, e)
            obs.counter(
                "reservation_registrations_total",
                help="REG messages accepted (retries re-register idempotently)",
            ).inc()
            # the reply carries the driver's wall clock: the client folds the
            # stamped round-trip into its NTP-style clock-offset estimate so
            # the trace merger can align per-host timelines (obs.tracing)
            msock.send({"type": "OK", "ts": time.time()})
        elif kind == "QUERY":
            msock.send({"type": "DONE", "data": self.reservations.done})
        elif kind == "QINFO":
            msock.send({"type": "INFO", "data": self.reservations.get()})
        elif kind == "QSTOP":
            msock.send({"type": "STOPPED", "data": self.stop_requested})
        elif kind == "STOP":
            logger.info("stop requested via control plane")
            self._stop_requested.set()
            msock.send({"type": "OK"})
        else:
            msock.send({"type": "ERROR", "data": "unknown message type {!r}".format(kind)})


#: env var: seconds a restarting driver is given to re-bind its rendezvous
#: socket before connection-refused executors give up
ENV_RESTART_WINDOW = "TOS_DRIVER_RESTART_WINDOW"

#: default driver-restart grace window (seconds)
DEFAULT_RESTART_WINDOW = 15.0


class Client:
    """Executor-side client for the reservation server.

    Opens one connection per request with bounded retries, because executors
    may race the server's startup and Spark may retry tasks (reference kept a
    connection but reconnect-retried ×3, reservation.py:221-246).

    Connection-refused is special-cased: nothing is listening on the
    rendezvous port, which during a driver restart is a *transient* state —
    the new driver re-binds (``TOS_TPU_SERVER_PORT`` pins the port precisely
    so this works) within the restart window. Rather than failing the
    executor on the first refusal, refusals are retried under a dedicated
    deadline-bounded policy (``restart_window`` seconds, env
    ``TOS_DRIVER_RESTART_WINDOW``); the error that finally surfaces names
    the rendezvous address and the elapsed retry budget so the operator can
    tell "driver never came back" from "wrong address".
    """

    RETRIES = 3
    #: retry schedule shared by every request (1s, 2s, ... capped at 5s —
    #: same envelope as the reference's fixed ``2 ** attempt`` sleep, now
    #: jittered so a fleet of racing executors doesn't reconnect in lockstep)
    BACKOFF = resilience.Backoff(base=1.0, factor=2.0, max_delay=5.0, jitter=0.5)

    def __init__(self, server_addr, timeout=30, restart_window=None, backoff=None):
        self.server_addr = (server_addr[0], int(server_addr[1]))
        self.timeout = timeout
        if restart_window is None:
            restart_window = float(
                os.environ.get(ENV_RESTART_WINDOW, str(DEFAULT_RESTART_WINDOW))
            )
        self.restart_window = restart_window
        backoff = backoff if backoff is not None else self.BACKOFF
        self._policy = resilience.RetryPolicy(
            max_attempts=self.RETRIES,
            backoff=backoff,
            retry_on=(OSError, ReservationError),
            on_retry=self._on_retry,
            name="reservation-client",
        )
        # connection-refused during a driver restart: retry until the window
        # closes, not until an attempt count runs out — the deadline is the
        # budget (attempt cap is just a runaway guard)
        self._restart_policy = resilience.RetryPolicy(
            max_attempts=256,
            backoff=backoff,
            retry_on=(ConnectionRefusedError,),
            timeout=self.restart_window,
            on_retry=self._on_restart_retry,
            name="reservation-restart-window",
        )

    @staticmethod
    def _on_retry(attempt, exc, delay):
        obs.counter(
            "reservation_client_retries_total",
            help="control-plane request attempts that failed and retried",
        ).inc()
        logger.debug("reservation request attempt %d failed (%s); retrying in %.1fs",
                     attempt + 1, exc, delay)

    @staticmethod
    def _on_restart_retry(attempt, exc, delay):
        obs.counter(
            "reservation_restart_retries_total",
            help="connection-refused retries inside the driver-restart window",
        ).inc()
        logger.info(
            "rendezvous refused connection (attempt %d) — assuming driver "
            "restart, retrying in %.1fs", attempt + 1, delay,
        )

    def _request_once(self, msg):
        if chaos.active and chaos.fire("reservation.client_reset"):
            raise ConnectionResetError("chaos: injected connection reset")
        with socket.create_connection(self.server_addr, timeout=self.timeout) as sock:
            msock = MessageSocket(sock)
            t0 = time.time()
            msock.send(msg)
            reply = msock.recv()
            t1 = time.time()
            if reply is None:
                raise ReservationError("server closed connection")
            if reply.get("type") == "ERROR":
                raise ReservationError(str(reply.get("data")))
            # driver-stamped replies double as clock-sync samples: per-attempt
            # wall clocks bracket exactly one round-trip (retries would
            # inflate the RTT and poison the NTP-style midpoint estimate)
            if "ts" in reply:
                tracing.observe_clock(float(reply["ts"]), t0, t1)
            return reply

    def _request(self, msg):
        try:
            return self._policy.call(self._request_once, msg)
        except ConnectionRefusedError:
            # nothing listening: plausibly a driver restart in progress.
            # Keep knocking until the restart window closes.
            started = time.monotonic()
            try:
                return self._restart_policy.call(self._request_once, msg)
            except (OSError, ReservationError, resilience.DeadlineExceeded) as e:
                elapsed = time.monotonic() - started
                raise ReservationError(
                    "could not reach reservation server at {}:{} after {:.1f}s of "
                    "connection-refused retries (driver restart window {:.0f}s): {}".format(
                        self.server_addr[0], self.server_addr[1],
                        elapsed, self.restart_window, e,
                    )
                ) from e
        except (OSError, ReservationError) as e:
            raise ReservationError(
                "could not reach reservation server at {}: {}".format(self.server_addr, e)
            ) from e

    # -- API -----------------------------------------------------------------

    def register(self, reservation):
        if chaos.active:
            chaos.delay("reservation.late_register")
        self._request({"type": "REG", "data": reservation})

    def get_reservations(self):
        return self._request({"type": "QINFO"})["data"]

    def await_reservations(self, timeout=600, poll_interval=1.0):
        """Poll until the cluster is complete; returns the full cluster info."""
        poll = resilience.Backoff(
            base=poll_interval, factor=1.0, max_delay=poll_interval, jitter=0.0
        )
        for _ in poll.attempts(deadline=resilience.Deadline(timeout)):
            if self._request({"type": "QUERY"})["data"]:
                return self.get_reservations()
        raise ReservationError("timed out awaiting full cluster")

    def request_stop(self):
        self._request({"type": "STOP"})

    def stop_requested(self):
        return self._request({"type": "QSTOP"})["data"]

    def close(self):  # connections are per-request; kept for API parity
        pass
