"""Per-executor IPC manager: the same-host feed channel into the jax process.

Capability-parity with /root/reference/tensorflowonspark/TFManager.py — a
``multiprocessing.managers.BaseManager`` exposing named joinable queues and a
key/value state store, in ``'local'`` (unix socket, same host) or ``'remote'``
(TCP, reachable from the driver) mode — re-designed around a single proxied
server-side object instead of module globals, so values returned from proxy
method calls are plain picklable objects rather than nested proxies.

In the TPU runtime this channel carries Spark partition data from the
short-lived Spark python workers into the long-lived per-host jax process,
where it is batched and ``jax.device_put`` onto the local chips (the infeed
analogue of the reference's queue → ``tf.data.from_generator`` path).
"""

import logging
import multiprocessing
import queue
import threading
from multiprocessing.managers import BaseManager

from tensorflowonspark_tpu_torch import chaos

logger = logging.getLogger(__name__)

#: queue names created by default for worker nodes
WORKER_QUEUES = ("input", "output", "error")
#: extra queue for driver-managed roles (reference: ps/evaluator 'control' queue)
CONTROL_QUEUES = ("input", "output", "error", "control")


class _Channel:
    """Server-side state: named joinable queues plus a k/v store.

    Lives inside the manager server process; clients interact through an
    auto-generated proxy, so every method's arguments/returns must be plain
    picklable values.
    """

    def __init__(self, qnames):
        self._queues = {name: queue.Queue() for name in qnames}
        self._kv = {}
        self._lock = threading.Lock()

    # k/v store -------------------------------------------------------------
    def kv_get(self, key, default=None):
        with self._lock:
            return self._kv.get(key, default)

    def kv_set(self, key, value):
        with self._lock:
            self._kv[key] = value

    # queue ops (routed by name to avoid nested proxies) --------------------
    def put(self, qname, item, block=True, timeout=None):
        self._queues[qname].put(item, block=block, timeout=timeout)

    def get(self, qname, block=True, timeout=None):
        return self._queues[qname].get(block=block, timeout=timeout)

    def task_done(self, qname):
        self._queues[qname].task_done()

    def join(self, qname):
        self._queues[qname].join()

    def unfinished(self, qname):
        # Queue.join() can't take a timeout; expose the unfinished-task count
        # so clients can poll with error-checking (reference polled the error
        # queue while joining in a thread, TFSparkNode.py:436-447).
        q = self._queues[qname]
        with q.all_tasks_done:
            return q.unfinished_tasks

    def qsize(self, qname):
        return self._queues[qname].qsize()

    def empty(self, qname):
        return self._queues[qname].empty()

    def queue_names(self):
        return sorted(self._queues)


class _ChannelManager(BaseManager):
    """Client-side manager class; knows the ``get_channel`` typeid only."""


_ChannelManager.register("get_channel")


#: the one _Channel instance inside a channel-server process
_server_channel = None


def _init_server_channel(qnames):
    global _server_channel
    _server_channel = _Channel(qnames)


def _get_server_channel():
    return _server_channel


class _HostManager(BaseManager):
    """Server-side manager class (module-level so the spawn start method can
    pickle its ``_run_server`` target)."""


_HostManager.register("get_channel", callable=_get_server_channel)


class QueueView:
    """A named-queue facade bound to one queue of an :class:`ExecutorIPC`.

    Provides the JoinableQueue-ish surface user code and the feed loops expect
    (put/get/task_done/join/empty/qsize).
    """

    __slots__ = ("_channel", "_name")

    def __init__(self, channel, name):
        self._channel = channel
        self._name = name

    def put(self, item, block=True, timeout=None):
        if chaos.active:
            chaos.delay("feed.stall")
        self._channel.put(self._name, item, block, timeout)

    def get(self, block=True, timeout=None):
        return self._channel.get(self._name, block, timeout)

    def get_nowait(self):
        return self._channel.get(self._name, False, None)

    def task_done(self):
        self._channel.task_done(self._name)

    def join(self):
        self._channel.join(self._name)

    def unfinished(self):
        return self._channel.unfinished(self._name)

    def empty(self):
        return self._channel.empty(self._name)

    def qsize(self):
        return self._channel.qsize(self._name)


class ExecutorIPC:
    """Handle to a (possibly remote) executor IPC channel.

    Wraps the BaseManager plumbing; what the rest of the framework passes
    around as ``mgr`` (reference code passed the raw TFManager).
    """

    def __init__(self, manager, address, authkey, mode):
        self._manager = manager
        self._channel = manager.get_channel()
        self.address = address
        self.authkey = authkey
        self.mode = mode

    # state machine: 'running' | 'terminating' | 'stopped'
    # (reference: TFSparkNode.py:195, TFNode.py:316, TFSparkNode.py:584-585)
    def get(self, key, default=None):
        return self._channel.kv_get(key, default)

    def set(self, key, value):
        self._channel.kv_set(key, value)

    def get_queue(self, qname):
        return QueueView(self._channel, qname)

    def queue_names(self):
        return self._channel.queue_names()

    def shutdown(self):
        try:
            self._manager.shutdown()
        except Exception:  # manager process may already be gone
            pass


def start(authkey, queues=WORKER_QUEUES, mode="local"):
    """Start a new IPC channel server for this executor.

    ``mode='local'`` binds a unix socket (same-host feed path);
    ``mode='remote'`` binds TCP on an ephemeral port so the driver can reach
    driver-managed roles at shutdown (reference TFManager.py:40-65).
    Returns an :class:`ExecutorIPC`.
    """
    if isinstance(authkey, str):
        authkey = authkey.encode("utf-8")
    # spawn context (fork from a threaded caller deadlocks — see
    # util.spawn_process); the channel object is created *inside* the server
    # process by the initializer, every get_channel proxy resolves to it
    ctx = multiprocessing.get_context("spawn")
    address = ("", 0) if mode == "remote" else None
    host = _HostManager(address=address, authkey=authkey, ctx=ctx)
    host.start(initializer=_init_server_channel, initargs=(tuple(queues),))
    # child processes of this process need the same authkey for digest auth
    multiprocessing.current_process().authkey = authkey
    addr = host.address
    if mode == "remote" and isinstance(addr, tuple):
        from tensorflowonspark_tpu_torch import util

        addr = (util.get_ip_address(), addr[1])
    logger.info("started %s IPC channel at %s", mode, addr)
    return ExecutorIPC(host, addr, authkey, mode)


def connect(address, authkey):
    """Connect to an existing channel (same-host unix socket or remote TCP)."""
    if isinstance(authkey, str):
        authkey = authkey.encode("utf-8")
    if isinstance(address, list):
        address = tuple(address)
    multiprocessing.current_process().authkey = authkey
    mgr = _ChannelManager(address=address, authkey=authkey)
    mgr.connect()
    mode = "local" if isinstance(address, str) else "remote"
    return ExecutorIPC(mgr, address, authkey, mode)
