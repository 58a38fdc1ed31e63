"""Model-bundle inference server + batch-inference CLI — the JVM-inference
equivalent; the port of the JAX package's ``serving.py``.

The reference shipped a Scala/JNI stack so JVM Spark jobs could run batch
inference without Python (the reference's ``src/main/scala/com/yahoo/
tensorflowonspark/Inference.scala:17``, ``TFModel.scala:38`` — SavedModelBundle
via libtensorflow). A PyTorch model has no JNI runtime to embed, so the
equivalent is a host RPC: this server owns the model bundle (and the card)
in a Python process, and any JVM executor talks to it over a tiny
length-prefixed protocol (``jvm/`` ships a dependency-free Java client for
Spark mapPartitions; the wire format is specified in jvm/README.md). The wire
is the JAX package's, byte for byte.

Protocol (4-byte big-endian length + UTF-8 JSON, same framing as the
reservation control plane):

* ``{"type": "ping"}`` → ``{"type": "pong"}``
* ``{"type": "info"}`` → ``{"type": "info", "export_dir": ..., "ready": true}``
* ``{"type": "predict", "inputs": {name: nested-lists, ...}}`` →
  ``{"type": "result", "outputs": {name: nested-lists, ...}}``
* ``{"type": "predict_binary", "columns": [{"name","dtype","shape"},...]}``
  followed by ONE raw frame (4-byte BE length + the columns' C-contiguous
  little-endian buffers concatenated in order) →
  ``{"type": "result_binary", "columns": [...]}`` + one raw frame — the
  native-buffer lane matching the class of the reference's JVM tensor path
  (TFModel.scala:121-244 moved tensors as nio buffers, not text).
* anything else / failure → ``{"type": "error", "message": ...}`` (an error
  reply is NEVER followed by a raw frame).

**Device.** The bundle loads through ``train/export.load_model`` on the
device the ``TOS_PLATFORM`` env lane names (:func:`platform_device`): the
card unless the lane says ``cpu`` (or the caller passes ``device="cpu"``).
The port's builders raise without a card; nothing falls back to the CPU. A
predict function may return torch tensors (on the card or not): they reach
the wire as host numpy (``detach().cpu().numpy()``).

**Trust boundary**: a model bundle contains pickled CODE
(``predict_builder.pkl``), executed when the bundle loads — the analogue of a
SavedModel executing its graph, but with Python's full power. Serve only
bundles you produced or vetted. For bundles from untrusted storage use
``--trusted_builder MODULE:ATTR``: the builder comes from your own code and
weights load from ``weights.npz`` with ``allow_pickle=False``, so nothing in
``--export_dir`` is unpickled (details: train/export.py docstring).

Batch CLI (the reference's ``Inference.scala:52-79`` analogue — TFRecords
in, predictions out as files, no server involved):

    python -m tensorflowonspark_tpu_torch.serving infer \
        --tfrecords /data/shards --export_dir /models/bundle \
        --output /data/preds [--format json|tfrecord] [--batch_size 128] \
        [--input_mapping feature=tensor ...] [--output_mapping tensor=col ...]

Start the server standalone:  ``python -m tensorflowonspark_tpu_torch.serving
serve --export_dir /path/bundle --port 8500`` (bare ``--export_dir ...``
still serves, as the older CLI did). ``TOS_PLATFORM=cpu`` serves on the CPU.
"""

import argparse
import json
import logging
import os
import queue
import socket
import threading

from tensorflowonspark_tpu_torch import chaos, obs, resilience
from tensorflowonspark_tpu_torch.reservation import MessageSocket

logger = logging.getLogger(__name__)

#: binary tensor frames can be big (a 128-row ResNet batch is ~77 MB f32);
#: framing itself lives on MessageSocket (send_raw/recv_raw) so one
#: implementation owns the wire format
MAX_BINARY_FRAME = int(os.environ.get("TOS_SERVING_MAX_FRAME", str(512 << 20)))


def _columns_to_arrays(columns, payload):
    """Decode the binary-lane column descriptors + concatenated payload."""
    import numpy as np

    arrays = {}
    offset = 0
    for col in columns:
        dtype = np.dtype(col["dtype"])
        shape = tuple(int(d) for d in col["shape"])
        nbytes = int(dtype.itemsize * int(np.prod(shape, dtype=np.int64)))
        if offset + nbytes > len(payload):
            raise ValueError("binary payload shorter than declared columns")
        arrays[col["name"]] = np.frombuffer(
            payload, dtype=dtype, count=int(np.prod(shape, dtype=np.int64)), offset=offset
        ).reshape(shape)
        offset += nbytes
    return arrays


def _arrays_to_columns(arrays):
    import numpy as np

    columns, parts = [], []
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype.byteorder == ">":  # ship little-endian on the wire
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        columns.append({"name": name, "dtype": arr.dtype.str, "shape": list(arr.shape)})
        parts.append(arr.tobytes())
    return columns, b"".join(parts)


def _to_numpy(value):
    """A predict output as a host numpy array: a torch tensor (on the card
    or not) is detached and copied to the host; anything else goes through
    ``np.asarray`` as before."""
    import numpy as np
    import torch

    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def platform_device():
    """The device a bundle loads on, from the ``TOS_PLATFORM`` env lane:
    ``None`` (the card: the port's builders take it and raise without one)
    when the lane is unset or ``gpu``, ``"cpu"`` when it says ``cpu``."""
    from tensorflowonspark_tpu_torch import util

    platform = os.environ.get(util.ENV_PLATFORM) or "gpu"
    if platform not in util.PLATFORMS:
        raise ValueError("{}={!r}; expected one of {}".format(
            util.ENV_PLATFORM, platform, util.PLATFORMS))
    return "cpu" if platform == "cpu" else None


def load_bundle(export_dir, trusted_builder=None, device=None):
    """``train/export.load_model`` on ``device`` (default: the env lane's,
    :func:`platform_device`). Returns ``(predict_fn, params, model_state,
    bound)``: ``bound`` is the CUDA device the predictor thread makes
    current before its first dispatch (torch keeps the current device per
    thread), or None when the bundle did not set up CUDA."""
    import torch

    from tensorflowonspark_tpu_torch.train import export

    if device is None:
        device = platform_device()
    predict_fn, params, model_state = export.load_model(
        export_dir, trusted_builder=trusted_builder, device=device
    )
    if device is not None:
        bound = torch.device(device)
    elif torch.cuda.is_initialized():
        # the builder took the card and made it current on this thread
        bound = torch.device("cuda", torch.cuda.current_device())
    else:
        return predict_fn, params, model_state, None
    return predict_fn, params, model_state, bound if bound.type == "cuda" else None


class Overloaded(RuntimeError):
    """Request shed because the predictor's pending queue is full."""


class DeadlineExceeded(RuntimeError):
    """Request shed because it waited in queue past its deadline."""


class _Predictor:
    """Single predictor thread owning the card: requests queue up, and
    same-signature requests that are waiting together coalesce into ONE
    model invocation (split back row-wise) — instead of a global lock,
    which would serialize N clients into N dispatches.

    A signature is (sorted column names, per-column dtype + trailing shape);
    only axis-0 (batch) concatenation is ever performed, so for row-wise
    models each reply holds the rows an individual run computes. On the CPU
    they are bit-identical to individual runs. On the card a coalesced
    dispatch has another batch size, for which cuDNN and cuBLAS may choose
    another algorithm, so rows agree with an individual run within the
    model's rounding, not bit for bit: ResNet-50 in bf16 on an H100 reads
    one bf16 ulp apart in places (a norm 2.6e-3 of the logits), while a
    dispatch of one request's own rows is bitwise (``chip_smoke.py``
    ``serve``).

    ``device`` is the CUDA device the bundle was built on (see
    :func:`load_bundle`): the predictor thread makes it current before its
    first dispatch. After :meth:`stop` the predictor drops its predict
    function and weights, so a swapped-out model's device memory can be
    reused.

    Tail-latency policy: the pending queue is BOUNDED
    (``max_pending`` requests, default ``TOS_SERVING_MAX_PENDING`` = 256) —
    a full queue sheds new requests with :class:`Overloaded` instead of
    growing an unbounded backlog behind a slow model; and each request may
    carry a deadline (``deadline_ms``, default ``TOS_SERVING_DEADLINE_MS``,
    0 = off) — a request still queued when its deadline passes is failed
    with :class:`DeadlineExceeded` rather than served arbitrarily late.
    Both surface to clients as the protocol's error reply.
    """

    def __init__(self, predict_fn, params, model_state, max_rows=None,
                 max_pending=None, deadline_ms=None, device=None):
        import collections

        self._device = device
        self._predict_fn = predict_fn
        self._params = params
        self._model_state = model_state
        self._max_rows = max_rows or int(os.environ.get("TOS_SERVING_COALESCE_ROWS", "1024"))
        self._max_pending = max_pending or int(os.environ.get("TOS_SERVING_MAX_PENDING", "256"))
        self._deadline_secs = (
            deadline_ms if deadline_ms is not None
            else int(os.environ.get("TOS_SERVING_DEADLINE_MS", "0"))
        ) / 1000.0
        # +1 slot so stop()'s sentinel can always enqueue behind a full load
        self._q = queue.Queue(maxsize=self._max_pending + 1)
        self._stop = object()
        #: exact pending count: incremented in submit, decremented when the
        #: request's future resolves — unlike qsize()+backlog it also covers
        #: the batch in flight inside _run, so the Overloaded gate is a hard
        #: bound
        self._pending = 0
        #: deferred non-matching requests, served FIRST next cycle — keeps
        #: FIFO so a minority-signature request can't be starved by sustained
        #: majority-signature load
        self._backlog = collections.deque()
        self._stopped = False
        #: newest request's column signature — what a hot-swap warm-up
        #: predict should look like (serving_mesh warms the new model off
        #: the request path before flipping)
        self._last_spec = None
        self._submit_lock = threading.Lock()
        self._requests_c = obs.counter(
            "serving_requests_total", help="predict requests submitted (shed ones included)"
        )
        self._shed_over_c = obs.counter(
            "serving_shed_overloaded_total", help="requests shed: pending queue full"
        )
        self._shed_deadline_c = obs.counter(
            "serving_shed_deadline_total", help="requests shed: queued past their deadline"
        )
        self._pending_g = obs.gauge(
            "serving_pending_depth", help="requests pending (queue + deferred backlog)"
        )
        self._latency_h = obs.histogram(
            "serving_request_seconds", help="end-to-end predict latency, submit to result"
        )
        self._thread = threading.Thread(target=self._run, name="tos-predictor", daemon=True)
        self._thread.start()

    def submit(self, arrays):
        """Blocking predict; thread-safe. Returns the outputs dict.

        Rejects malformed requests HERE (0-d arrays, mismatched leading
        dims, empty input dict) so a bad request becomes the caller's error
        reply, never a predictor-thread crash. Sheds with
        :class:`Overloaded` when ``max_pending`` requests are queued."""
        import time as _time

        import numpy as np
        from concurrent.futures import Future

        self._requests_c.inc()
        if not arrays:
            raise ValueError("predict requires at least one input column")
        lead = set()
        spec = []
        for name, arr in arrays.items():
            arr = np.asarray(arr)
            if arr.ndim == 0:
                raise ValueError(
                    "input {!r} is a scalar; batch inputs need a leading "
                    "(row) dimension".format(name)
                )
            lead.add(arr.shape[0])
            spec.append((name, arr.dtype.str, tuple(arr.shape[1:])))
        if len(lead) != 1:
            raise ValueError("input columns disagree on row count: {}".format(sorted(lead)))

        deadline = (
            _time.monotonic() + self._deadline_secs if self._deadline_secs > 0 else None
        )
        if chaos.active and chaos.fire("serving.overload"):
            self._shed_over_c.inc()
            raise Overloaded("chaos: injected transient overload; request shed")
        fut = Future()
        # the lock orders every put against stop()'s sentinel: a submit that
        # wins the race enqueues BEFORE the sentinel (the run thread serves
        # it), one that loses raises — no future can be orphaned
        with self._submit_lock:
            self._last_spec = tuple(sorted(spec))
            if self._stopped:
                raise RuntimeError("predictor stopped")
            # _pending counts every unresolved request — queued, parked in
            # the backlog, AND coalesced into the batch _run is currently
            # dispatching — so max_pending is exact: the old
            # qsize()+backlog read went soft by one in-flight batch
            self._pending_g.set(self._pending)
            if self._pending >= self._max_pending:
                self._shed_over_c.inc()
                raise Overloaded(
                    "server overloaded: {} requests pending; request shed".format(
                        self._max_pending
                    )
                )
            self._pending += 1
            # registered before the put: the consumer cannot resolve a
            # future it has not yet been handed
            fut.add_done_callback(self._release_pending)
            self._q.put((arrays, fut, deadline))
        with self._latency_h.time():
            return fut.result()

    def _release_pending(self, _fut):
        with self._submit_lock:
            self._pending -= 1
            self._pending_g.set(self._pending)

    def warm_spec(self):
        """Column signature of the newest submitted request — sorted
        ``(name, dtype, trailing shape)`` triples, or None before the first
        request."""
        with self._submit_lock:
            return self._last_spec

    def stop(self):
        with self._submit_lock:
            if not self._stopped:
                # first stop only: the bounded queue holds at most
                # max_pending requests (submit gates on that), so the +1
                # slot guarantees this put never blocks — but a SECOND
                # sentinel would fill the queue and block forever while
                # holding _submit_lock. stop() must stay idempotent
                # (server shutdown paths can reach it more than once).
                self._stopped = True
                self._q.put(self._stop)
        self._thread.join(timeout=60)
        if self._thread.is_alive():
            # an in-flight predict (e.g. a first call that builds a kernel) outlived
            # the join: the thread still owns the queue/backlog and will
            # serve everything up to the sentinel, then exit. Draining here
            # would steal the sentinel and race its Future operations.
            logger.warning("predictor still busy at stop(); it will drain and exit")
            return
        # thread exited: fail anything still queued so no caller blocks
        # forever on a future that will never resolve
        leftovers = list(self._backlog)
        self._backlog.clear()
        while True:
            try:
                leftovers.append(self._q.get_nowait())
            except queue.Empty:
                break
        for item in leftovers:
            if item is not self._stop:
                item[1].set_exception(RuntimeError("predictor stopped"))

    # -- internals ----------------------------------------------------------

    @staticmethod
    def _signature(arrays):
        return tuple(
            (name, arrays[name].dtype.str, arrays[name].shape[1:])
            for name in sorted(arrays)
        )

    def _expired(self, item):
        """Fail a queued request whose deadline passed; True if it was."""
        import time as _time

        if item[2] is not None and _time.monotonic() > item[2]:
            self._shed_deadline_c.inc()
            item[1].set_exception(
                DeadlineExceeded(
                    "request shed: queued past its {:.0f} ms deadline".format(
                        self._deadline_secs * 1000
                    )
                )
            )
            return True
        return False

    def _run(self):
        import numpy as np
        import torch

        if self._device is not None:
            # the current CUDA device is per thread: this one dispatches
            torch.cuda.set_device(self._device)
        while True:
            item = self._backlog.popleft() if self._backlog else self._q.get()
            if item is self._stop:
                # drain anything that raced in behind the sentinel
                for pending in self._backlog:
                    pending[1].set_exception(RuntimeError("predictor stopped"))
                self._backlog.clear()
                # nothing dispatches after the sentinel: let the model and
                # its weights go (a hot swap's old generation frees its
                # device memory here)
                self._predict_fn = self._params = self._model_state = None
                return
            if self._expired(item):
                continue
            batch = [item]
            try:
                sig = self._signature(item[0])
                rows = next(iter(item[0].values())).shape[0]
            except Exception as e:  # malformed request that slipped validation
                item[1].set_exception(e)
                continue
            # coalesce same-signature requests: deferred (older) ones first,
            # then whatever is already waiting on the queue. Non-matching
            # requests keep FIFO order in the backlog, whose head seeds the
            # next cycle — mixed-signature load batches per signature instead
            # of degrading to one request per dispatch. A request that would
            # push the batch past max_rows is DEFERRED, not appended: the
            # dispatch shape stays within the operator's bound, so the
            # power-of-two padding below keeps its shape-reuse guarantee
            # under sustained load.
            deferred = []

            def _admit(nxt):
                """Coalesce nxt into the batch, defer it, or expire it —
                one admission policy shared by both scan loops below."""
                nonlocal rows
                if self._expired(nxt):
                    return
                if nxt[0] and self._signature(nxt[0]) == sig:
                    nxt_rows = next(iter(nxt[0].values())).shape[0]
                    if rows + nxt_rows <= self._max_rows:
                        batch.append(nxt)
                        rows += nxt_rows
                        return
                deferred.append(nxt)

            saw_stop = False
            while self._backlog and rows < self._max_rows:
                nxt = self._backlog.popleft()
                if nxt is self._stop:
                    deferred.append(nxt)
                    saw_stop = True
                    break
                _admit(nxt)
            while not saw_stop and rows < self._max_rows:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is self._stop:
                    deferred.append(nxt)
                    break
                _admit(nxt)
            # deferred items are older than anything left in the backlog
            # (the pending gauge is driven by _release_pending)
            self._backlog.extendleft(reversed(deferred))

            if chaos.active:
                chaos.delay("serving.latency")
            try:
                if len(batch) == 1:
                    arrays = batch[0][0]
                else:
                    arrays = {
                        name: np.concatenate([req[0][name] for req in batch])
                        for name in batch[0][0]
                    }
                    # pad coalesced batches up to a power-of-two bucket:
                    # the model then sees at most log2(max_rows) + 1 batch
                    # sizes, so what the card keys on the shape (cuDNN's
                    # and cuBLAS's algorithm choice, the caching
                    # allocator's blocks) is reused instead of chosen anew
                    # for every distinct total, and the rows dispatched are
                    # the JAX package's. Single requests keep their exact shape —
                    # the client's batch size is the client's contract.
                    # Row-wise semantics make the padding rows inert; the
                    # per-request split below never reads them. Coalesced
                    # rows never exceed _max_rows (overshooters are
                    # deferred above), so the cap only canonicalizes the
                    # top bucket when _max_rows is not a power of two.
                    bucket = min(1 << (rows - 1).bit_length(), self._max_rows)
                    if bucket > rows:
                        arrays = {
                            name: np.concatenate(
                                [a, np.zeros((bucket - rows,) + a.shape[1:], a.dtype)]
                            )
                            for name, a in arrays.items()
                        }
                outputs = self._predict_fn(self._params, self._model_state, arrays)
                if not isinstance(outputs, dict):
                    outputs = {"output": outputs}
                outputs = {name: _to_numpy(v) for name, v in outputs.items()}
            except Exception as e:
                for _arrays, fut, _deadline in batch:
                    fut.set_exception(e)
                continue
            if len(batch) == 1:
                batch[0][1].set_result(outputs)
            else:
                start = 0
                for req_arrays, fut, _deadline in batch:
                    n = next(iter(req_arrays.values())).shape[0]
                    fut.set_result(
                        {name: v[start : start + n] for name, v in outputs.items()}
                    )
                    start += n


class ProtocolServer:
    """Socket/accept/connection machinery for the wire protocol in the
    module docstring, decoupled from where predictions actually run.
    Subclasses supply ``_submit(arrays) -> outputs`` (dict of numpy arrays
    in and out) and ``_info() -> dict``: :class:`InferenceServer` plugs in
    a local :class:`_Predictor`; the mesh frontend
    (:class:`~tensorflowonspark_tpu_torch.serving_mesh.MeshFrontend`) plugs in a
    replica router.

    Connections are handled by a bounded thread pool
    (``TOS_SERVING_THREADS``, default 32) instead of an unbounded
    thread-per-connection."""

    def __init__(self, host="", port=0, max_threads=None, name="tos-serving"):
        self._max_threads = max_threads or int(os.environ.get("TOS_SERVING_THREADS", "32"))
        self._name = name
        self._pool = None
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.address = self._sock.getsockname()
        self._shutdown = threading.Event()
        self._thread = None
        #: live client connections — closed on stop() so pool threads blocked
        #: in recv() unblock (pool threads are non-daemon; without this an
        #: idle persistent client would hang interpreter shutdown)
        self._conns = set()
        self._conns_lock = threading.Lock()

    def start(self):
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(
            max_workers=self._max_threads, thread_name_prefix=self._name
        )
        self._thread = threading.Thread(
            target=self._serve, name=self._name + "-accept", daemon=True
        )
        self._thread.start()
        logger.info("%s listening at %s", self._name, self.address)
        return self.address

    def stop(self):
        self._shutdown.set()
        try:
            with socket.create_connection(("127.0.0.1", self.address[1]), timeout=1):
                pass
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=10)
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        self._stop_workload()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        try:
            self._sock.close()
        except OSError:
            pass

    def kill(self):
        """SIGKILL-shaped death for chaos tests: close the listening socket
        and every live connection with no drain — in-flight requests see a
        connection reset, exactly what a killed process produces.
        :meth:`stop` may still be called afterwards to reap threads."""
        self._shutdown.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    # -- subclass surface ------------------------------------------------------

    def _submit(self, arrays):
        """Run one predict (dict of numpy arrays -> dict of numpy arrays)."""
        raise NotImplementedError

    def _info(self):
        return {"type": "info", "ready": True}

    def _stop_workload(self):
        """Hook: drain subclass-owned work after connections close and
        before the handler pool shuts down."""

    # -- internals ------------------------------------------------------------

    def _serve(self):
        while not self._shutdown.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return
            if self._shutdown.is_set():
                conn.close()
                return
            self._pool.submit(self._handle_conn, conn)

    def _handle_conn(self, conn):
        with self._conns_lock:
            self._conns.add(conn)
        # close the race with stop(): registration above + this check means
        # any connection either appears in stop()'s snapshot or observes the
        # shutdown flag here — no handler can survive blocked in recv()
        if self._shutdown.is_set():
            try:
                conn.close()
            finally:
                with self._conns_lock:
                    self._conns.discard(conn)
            return
        msock = MessageSocket(conn)
        try:
            while True:
                try:
                    msg = msock.recv()
                except (OSError, ValueError):
                    return
                if msg is None:
                    return
                if chaos.active and chaos.fire("serving.conn_drop"):
                    return  # close the connection mid-request
                try:
                    if isinstance(msg, dict) and msg.get("type") == "predict_binary":
                        self._handle_binary(msock, msg)
                    else:
                        msock.send(self._handle(msg))
                except (OSError, ConnectionError):
                    return
        finally:
            msock.close()
            with self._conns_lock:
                self._conns.discard(conn)

    def _handle_binary(self, msock, msg):
        # recv_raw consumes oversize frames before raising, so an error
        # reply always leaves the stream positioned at the next message
        # (the documented lone-JSON-frame error contract)
        try:
            payload = msock.recv_raw(MAX_BINARY_FRAME)
        except ValueError as e:
            msock.send({"type": "error", "message": str(e)})
            return
        if payload is None:
            raise ConnectionError("client closed mid-request")
        try:
            arrays = _columns_to_arrays(msg.get("columns") or [], payload)
            outputs = self._submit(arrays)
            columns, out_payload = _arrays_to_columns(outputs)
        except (Overloaded, DeadlineExceeded) as e:
            # expected under load-shedding policy: no traceback spam
            logger.warning("binary predict shed: %s", e)
            msock.send({"type": "error", "message": "{}: {}".format(type(e).__name__, e)})
            return
        except Exception as e:
            logger.exception("binary predict failed")
            msock.send({"type": "error", "message": "{}: {}".format(type(e).__name__, e)})
            return
        msock.send({"type": "result_binary", "columns": columns})
        msock.send_raw(out_payload)

    def _handle(self, msg):
        kind = msg.get("type") if isinstance(msg, dict) else None
        if kind == "ping":
            return {"type": "pong"}
        if kind == "info":
            return self._info()
        if kind == "predict":
            try:
                return {"type": "result", "outputs": self._predict(msg.get("inputs") or {})}
            except (Overloaded, DeadlineExceeded) as e:
                logger.warning("predict shed: %s", e)
                return {"type": "error", "message": "{}: {}".format(type(e).__name__, e)}
            except Exception as e:
                logger.exception("predict failed")
                return {"type": "error", "message": "{}: {}".format(type(e).__name__, e)}
        return {"type": "error", "message": "unknown message type {!r}".format(kind)}

    def _predict(self, inputs):
        import numpy as np

        arrays = {name: np.asarray(vals) for name, vals in inputs.items()}
        outputs = self._submit(arrays)
        return {name: _to_numpy(v).tolist() for name, v in outputs.items()}


class InferenceServer(ProtocolServer):
    """Serve one exported model bundle over TCP.

    Predictions funnel through the coalescing :class:`_Predictor`. The
    predictor slot is hot-swappable: :meth:`swap_predictor` installs a new
    one atomically (the serving mesh's zero-downtime model swap) while
    requests already dispatched drain on the old one.

    The bundle loads on ``device``: by default the ``TOS_PLATFORM`` lane's
    (:func:`platform_device`: the card unless the lane says ``cpu``)."""

    def __init__(self, export_dir, host="", port=0, max_threads=None, trusted_builder=None,
                 device=None):
        self.export_dir = export_dir
        predict_fn, params, model_state, bound = load_bundle(
            export_dir, trusted_builder=trusted_builder, device=device
        )
        #: the CUDA device the bundle was built on (None off the card)
        self.device = bound
        self._pred_lock = threading.Lock()
        self._predictor = _Predictor(predict_fn, params, model_state, device=bound)
        ProtocolServer.__init__(self, host=host, port=port, max_threads=max_threads)

    def swap_predictor(self, predictor, export_dir=None):
        """Atomically install ``predictor`` (zero-downtime hot swap) and
        return the old one. Requests already dispatched keep draining on
        the old predictor; the caller stops it after the flip."""
        with self._pred_lock:
            old = self._predictor
            self._predictor = predictor
            if export_dir is not None:
                self.export_dir = export_dir
        return old

    def warm_spec(self):
        """Column signature of the newest request seen by the current
        predictor — what a hot-swap warm-up predict should look like."""
        with self._pred_lock:
            predictor = self._predictor
        return predictor.warm_spec()

    def _submit(self, arrays):
        with self._pred_lock:
            predictor = self._predictor
        return predictor.submit(arrays)

    def _info(self):
        return {"type": "info", "export_dir": self.export_dir, "ready": True}

    def _stop_workload(self):
        with self._pred_lock:
            predictor = self._predictor
        predictor.stop()


class InferenceClient:
    """Python twin of the JVM client (jvm/.../InferenceClient.java).

    Transient failures are absorbed by a shared
    :class:`~tensorflowonspark_tpu_torch.resilience.RetryPolicy`: a dropped
    connection is re-dialed and the request re-sent (prediction is
    stateless, so replay is safe), and an ``Overloaded`` shed reply is
    retried after backoff — the client half of the server's load-shedding
    contract. Pass ``retry=RetryPolicy(max_attempts=1)`` for the old
    fail-fast behavior. Non-transient error replies (bad inputs, model
    failures) raise immediately."""

    def __init__(self, address, timeout=120, retry=None):
        self.address = (address[0], int(address[1]))
        self.timeout = timeout
        self._sock = None
        self._msock = None
        self._policy = retry if retry is not None else resilience.RetryPolicy(
            max_attempts=3,
            backoff=resilience.Backoff(base=0.2, factor=2.0, max_delay=2.0, jitter=0.5),
            retry_on=(OSError, Overloaded),
            name="inference-client",
        )
        self._connect()

    def _connect(self):
        self._sock = socket.create_connection(self.address, timeout=self.timeout)
        self._msock = MessageSocket(self._sock)

    def _reset(self):
        if self._msock is not None:
            self._msock.close()
        self._sock = None
        self._msock = None

    @staticmethod
    def _check_reply(reply):
        if reply.get("type") == "error":
            message = str(reply.get("message") or "")
            if message.startswith("Overloaded"):
                raise Overloaded(message)  # transient shed: retryable
            raise RuntimeError(message)
        return reply

    def _roundtrip(self, msg):
        if self._msock is None:
            self._connect()
        try:
            self._msock.send(msg)
            reply = self._msock.recv()
        except OSError:
            self._reset()
            raise
        if reply is None:
            self._reset()
            raise ConnectionError("inference server closed the connection")
        return self._check_reply(reply)

    def _call(self, fn, *args):
        """Run a protocol roundtrip under the retry policy. When the budget
        is exhausted, the final error NAMES the server address, attempt
        count, and elapsed budget (the contract the reservation client's
        driver-restart path set) instead of surfacing the bare last error."""
        import time as _time

        started = _time.monotonic()
        try:
            return self._policy.call(fn, *args)
        except Overloaded as e:
            elapsed = _time.monotonic() - started
            raise Overloaded(
                "Overloaded: inference server at {}:{} kept shedding after {} "
                "attempt(s) over {:.1f}s: {}".format(
                    self.address[0] or "127.0.0.1", self.address[1],
                    self._policy.max_attempts, elapsed, e,
                )
            ) from e
        except (OSError, resilience.DeadlineExceeded) as e:
            elapsed = _time.monotonic() - started
            raise ConnectionError(
                "inference server at {}:{} unreachable after {} attempt(s) "
                "over {:.1f}s: {}".format(
                    self.address[0] or "127.0.0.1", self.address[1],
                    self._policy.max_attempts, elapsed, e,
                )
            ) from e

    def _request(self, msg):
        return self._call(self._roundtrip, msg)

    def ping(self):
        return self._request({"type": "ping"})["type"] == "pong"

    def info(self):
        return self._request({"type": "info"})

    def predict(self, **inputs):
        """Column name → nested lists / numpy arrays; returns dict of lists."""
        inputs = {
            k: v.tolist() if hasattr(v, "tolist") else v for k, v in inputs.items()
        }
        return self._request({"type": "predict", "inputs": inputs})["outputs"]

    def predict_binary(self, **inputs):
        """Binary tensor lane: numpy arrays in, numpy arrays out — no JSON
        text encoding of the payloads (see module docstring)."""
        import numpy as np

        arrays = {k: np.asarray(v) for k, v in inputs.items()}
        columns, payload = _arrays_to_columns(arrays)

        def _round():
            if self._msock is None:
                self._connect()
            try:
                self._msock.send({"type": "predict_binary", "columns": columns})
                self._msock.send_raw(payload)
                reply = self._msock.recv()
                if reply is None:
                    self._reset()
                    raise ConnectionError("inference server closed the connection")
                self._check_reply(reply)  # error replies carry no raw frame
                out_payload = self._msock.recv_raw(MAX_BINARY_FRAME)
                if out_payload is None:
                    self._reset()
                    raise ConnectionError("inference server closed mid-reply")
            except OSError:
                self._reset()
                raise
            return _columns_to_arrays(reply["columns"], out_payload)

        return self._call(_round)

    def close(self):
        self._reset()


# -- batch inference CLI (Inference.scala analogue) ----------------------------


def _parse_mapping(pairs):
    out = {}
    for pair in pairs or []:
        if "=" not in pair:
            raise ValueError("mapping must be key=value, got {!r}".format(pair))
        k, v = pair.split("=", 1)
        out[k] = v
    return out


def run_batch_inference(
    tfrecords_dir,
    export_dir,
    output_dir,
    batch_size=128,
    input_mapping=None,
    output_mapping=None,
    out_format="json",
    server=None,
    trusted_builder=None,
    device=None,
):
    """TFRecord shards → bundle predictions → output shards (one output shard
    per input shard; ``json`` = one JSON object per record per line,
    ``tfrecord`` = serialized Examples). Reference ``Inference.scala:52-79``:
    loadTFRecords → TFModel.transform → write.json.

    ``input_mapping``: feature name → model input name (default: every
    non-bytes feature feeds an input of the same name). ``output_mapping``:
    model output name → output column name (default: keep names).
    ``server``: ``(host, port)`` of a running :class:`InferenceServer` —
    batches go over the binary tensor lane instead of loading the bundle
    in-process (what a JVM executor does; ``export_dir`` may be None then).
    ``device``: where the bundle loads in-process (default: the
    ``TOS_PLATFORM`` lane's, :func:`platform_device`).
    """
    import numpy as np

    from tensorflowonspark_tpu_torch import tfrecord

    if server is not None:
        client = InferenceClient(server)
        predictor = None

        def _submit(arrays):
            return client.predict_binary(**arrays)

        def _stop():
            client.close()
    else:
        predict_fn, params, model_state, bound = load_bundle(
            export_dir, trusted_builder=trusted_builder, device=device
        )
        predictor = _Predictor(predict_fn, params, model_state, device=bound)
        _submit = predictor.submit
        _stop = predictor.stop
    shards = tfrecord.list_shards(tfrecords_dir)
    if not shards:
        raise FileNotFoundError("no TFRecord shards under {}".format(tfrecords_dir))
    os.makedirs(output_dir, exist_ok=True)
    in_map = dict(input_mapping or {})
    out_map = dict(output_mapping or {})
    total = 0

    def _rows_to_arrays(rows):
        cols = {}
        for name in rows[0]:
            if in_map and name not in in_map:
                continue
            vals = [r[name] for r in rows]
            if any(isinstance(v, (bytes, bytearray)) for v in vals[0]):
                continue  # bytes features are not numeric model inputs
            arr = np.asarray(vals)
            if arr.shape[-1] == 1:  # scalar features decode as length-1 lists
                arr = arr.reshape(arr.shape[:-1])
            cols[in_map.get(name, name)] = arr
        if not cols:
            raise ValueError(
                "no numeric input features in records (features: {})".format(sorted(rows[0]))
            )
        return cols

    def _emit(outputs, n):
        renamed = {out_map.get(name, name): _to_numpy(v) for name, v in outputs.items()}
        for i in range(n):
            yield {name: np.asarray(v[i]).tolist() for name, v in renamed.items()}

    try:
        for shard in shards:
            rows = [
                {name: vals for name, (_kind, vals) in tfrecord.decode_example(rec).items()}
                for rec in tfrecord.read_records(shard)
            ]
            base = os.path.basename(shard)
            out_path = os.path.join(
                output_dir, base + (".jsonl" if out_format == "json" else "")
            )
            records_out = []
            for start in range(0, len(rows), batch_size):
                chunk = rows[start : start + batch_size]
                outputs = _submit(_rows_to_arrays(chunk))
                records_out.extend(_emit(outputs, len(chunk)))
            if out_format == "json":
                with open(out_path, "w") as f:
                    for rec in records_out:
                        f.write(json.dumps(rec) + "\n")
            else:
                with tfrecord.TFRecordWriter(out_path) as w:
                    for rec in records_out:
                        w.write(
                            tfrecord.encode_example(
                                {
                                    k: v if isinstance(v, list) else [v]
                                    for k, v in rec.items()
                                }
                            )
                        )
            total += len(records_out)
            logger.info("wrote %d predictions to %s", len(records_out), out_path)
    finally:
        _stop()
    return total


#: set by :func:`_wait_for_exit` while a blocking ``main()`` is serving;
#: tests set it to shut the CLI down as cleanly as a Ctrl-C would
_exit_event = None


def _wait_for_exit():
    global _exit_event
    _exit_event = threading.Event()
    try:
        _exit_event.wait()
    except KeyboardInterrupt:
        pass
    finally:
        _exit_event = None


def main(argv=None):
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    # compat with the older CLI: bare `--export_dir ...` means `serve` — but top-level
    # --help must still show BOTH subcommands
    if not argv:
        argv = ["serve"]
    elif argv[0].startswith("-") and argv[0] not in ("-h", "--help"):
        argv = ["serve"] + argv

    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    serve_p = sub.add_parser("serve", help="serve a bundle over TCP")
    serve_p.add_argument("--export_dir", required=True)
    serve_p.add_argument("--host", default="")
    serve_p.add_argument("--port", type=int, default=8500)
    serve_p.add_argument(
        "--metrics_port", type=int, default=0, metavar="PORT",
        help="serve Prometheus metrics (GET /metrics) and the raw snapshot "
             "(GET /metrics.json) on this port; 0 (default) disables the endpoint")
    serve_p.add_argument(
        "--trusted_builder", default=None, metavar="MODULE:ATTR",
        help="take the predict-fn builder from your own code instead of the "
             "bundle's pickle; with npz weights, nothing from --export_dir "
             "is unpickled (safe for untrusted storage). Without this flag "
             "the bundle is TRUSTED: loading it executes its pickled code.")

    mesh_p = sub.add_parser(
        "mesh", help="serve N replicas behind one routed, hedging endpoint"
    )
    mesh_p.add_argument("--export_dir", required=True,
                        help="bundle dir or serving_mesh generation-pointer dir")
    mesh_p.add_argument("--replicas", type=int, default=3)
    mesh_p.add_argument("--host", default="")
    mesh_p.add_argument("--port", type=int, default=8500,
                        help="the routed frontend's port (replicas bind ephemeral ports)")
    mesh_p.add_argument(
        "--metrics_port", type=int, default=0, metavar="PORT",
        help="serve Prometheus metrics on this port; the snapshot includes "
             "the mesh gauges (serving_replicas_active etc.), so scraping "
             "any mesh process shows replica health; 0 disables")
    mesh_p.add_argument("--hedge_ms", type=float, default=0.0,
                        help="hedge a request to a second replica when the first "
                             "has not answered within this many ms; 0 disables")
    mesh_p.add_argument("--trusted_builder", default=None, metavar="MODULE:ATTR",
                        help="safe-load lane for --export_dir (see serve --help)")

    infer_p = sub.add_parser("infer", help="batch inference: TFRecords -> prediction shards")
    infer_p.add_argument("--tfrecords", required=True, help="input TFRecord shard dir")
    infer_p.add_argument("--export_dir", default=None,
                         help="bundle dir (in-process inference; omit with --server)")
    infer_p.add_argument("--output", required=True, help="output dir for prediction shards")
    infer_p.add_argument("--batch_size", type=int, default=128)
    infer_p.add_argument("--format", choices=["json", "tfrecord"], default="json")
    infer_p.add_argument("--input_mapping", nargs="*", default=None, metavar="FEATURE=TENSOR")
    infer_p.add_argument("--output_mapping", nargs="*", default=None, metavar="TENSOR=COLUMN")
    infer_p.add_argument("--server", default=None, metavar="HOST:PORT",
                         help="route batches to a running InferenceServer over "
                              "the binary tensor lane instead of loading the bundle")
    infer_p.add_argument("--trusted_builder", default=None, metavar="MODULE:ATTR",
                         help="safe-load lane for --export_dir (see serve --help)")

    args = parser.parse_args(argv)
    from tensorflowonspark_tpu_torch import util

    util.setup_logging()

    if args.command == "infer":
        if args.server is None and args.export_dir is None:
            infer_p.error("one of --export_dir / --server is required")
        server_addr = None
        if args.server is not None:
            host, _, port = args.server.rpartition(":")
            if not port.isdigit():
                infer_p.error("--server must be HOST:PORT, got {!r}".format(args.server))
            server_addr = (host or "127.0.0.1", int(port))
        total = run_batch_inference(
            args.tfrecords, args.export_dir, args.output,
            batch_size=args.batch_size,
            input_mapping=_parse_mapping(args.input_mapping),
            output_mapping=_parse_mapping(args.output_mapping),
            out_format=args.format,
            server=server_addr,
            trusted_builder=args.trusted_builder,
        )
        print(json.dumps({"inferred": total, "output": args.output}), flush=True)
        return

    if args.command == "mesh":
        from tensorflowonspark_tpu_torch import serving_mesh

        mesh = serving_mesh.ServingMesh(
            args.export_dir, replicas=args.replicas,
            trusted_builder=args.trusted_builder,
        )
        mesh.start()
        router = mesh.router(
            hedge_after=args.hedge_ms / 1000.0 if args.hedge_ms > 0 else None
        )
        front = serving_mesh.MeshFrontend(router, host=args.host, port=args.port)
        host, port = front.start()
        metrics_server = None
        if args.metrics_port:
            from tensorflowonspark_tpu_torch.obs import exporter

            # the process-global snapshot carries the mesh gauges
            # (serving_replicas_active, failover/hedge/swap counters), so a
            # scrape of this endpoint shows mesh health, not just one replica
            metrics_server = exporter.MetricsHTTPServer(
                obs.snapshot, host=args.host, port=args.metrics_port
            ).start()
        print(
            json.dumps(
                {
                    "serving": args.export_dir,
                    "mesh": True,
                    "replicas": args.replicas,
                    "host": host or "0.0.0.0",
                    "port": port,
                    "metrics_port": metrics_server.address[1] if metrics_server else None,
                }
            ),
            flush=True,
        )
        _wait_for_exit()
        if metrics_server is not None:
            metrics_server.stop()
        front.stop()
        router.close()
        mesh.stop()
        return

    server = InferenceServer(
        args.export_dir, args.host, args.port, trusted_builder=args.trusted_builder
    )
    host, port = server.start()
    metrics_server = None
    if args.metrics_port:
        from tensorflowonspark_tpu_torch.obs import exporter

        metrics_server = exporter.MetricsHTTPServer(
            obs.snapshot, host=args.host, port=args.metrics_port
        ).start()
    print(
        json.dumps(
            {
                "serving": args.export_dir,
                "host": host or "0.0.0.0",
                "port": port,
                "metrics_port": metrics_server.address[1] if metrics_server else None,
            }
        ),
        flush=True,
    )
    _wait_for_exit()
    if metrics_server is not None:
        metrics_server.stop()
    server.stop()


if __name__ == "__main__":
    main()
