"""Host-side bucketed all-reduce group — the comm-thread gradient-sync path;
the port of the JAX package's ``parallel/hostreduce.py``.

A gather-sum-broadcast over host TCP sockets, driven from a dedicated comm
thread (:class:`~tensorflowonspark_tpu_torch.train.strategy.BucketedOverlap`),
waits in ``epoll`` beside the device: the card keeps running the next
microbatch's backward while the socket wait and the bucket sum happen on
the host. It is the Horovod-lineage design of the reference (a side stream
of collectives next to the compute stream), rebuilt at the host layer this
repo owns; it needs no NCCL, so it also joins processes that share one card
(NCCL takes no two ranks on one device).

Determinism contract: rank 0 receives every peer's buffer, sums **in rank
order**, divides by the world size, and broadcasts the result — so every
rank applies bitwise-identical reduced gradients, and two runs with the same
inputs reduce to the same bits regardless of socket arrival order.

Bootstrap: pass ``root_address`` explicitly ("host:port" that rank 0 binds),
or leave it ``None`` in an initialized ``torch.distributed`` world and rank
0 binds an ephemeral port and publishes ``127.0.0.1:<port>`` to its peers
with ``dist.broadcast_object_list`` over ``process_group`` (None: the
world; a group is the subset of ranks this group joins, e.g. the ``dp``
ranks of one ``tp`` position, each rank's ``rank`` its index in it).
``world == 1`` degenerates to a local mean (no sockets at all).
"""

import logging
import socket
import struct
import threading
import time

from tensorflowonspark_tpu_torch import chaos, obs, resilience

logger = logging.getLogger(__name__)

_LEN = struct.Struct("<q")


def _send_msg(sock, payload):
    sock.sendall(_LEN.pack(len(payload)))
    sock.sendall(payload)


def _recv_exact(sock, n):
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionResetError("hostreduce peer closed mid-message")
        got += r
    return bytes(buf)


def _recv_msg(sock):
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return _recv_exact(sock, n)


def _world_up():
    try:
        import torch.distributed as dist
    except ImportError:  # pragma: no cover - torch without distributed
        return False
    return dist.is_available() and dist.is_initialized()


def _exchange_root(address, process_group):
    """Rank 0's ``address`` on every rank of ``process_group`` (one
    ``broadcast_object_list`` from its first member; collective)."""
    import torch
    import torch.distributed as dist

    src = 0 if process_group is None else dist.get_global_rank(process_group, 0)
    box = [address]
    device = None
    if dist.get_backend(process_group) == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    dist.broadcast_object_list(box, src=src, group=process_group, device=device)
    return box[0]


class HostAllReduceGroup:
    """A fixed group of ranks doing deterministic mean all-reduces over TCP.

    Every rank must call :meth:`allreduce_mean` the same number of times in
    the same order (the per-connection byte streams are the sequencing) —
    exactly the discipline gradient buckets already have. Calls are
    serialized by an internal lock, so a single comm thread (or careful
    callers) can share the group.
    """

    def __init__(self, rank, world, root_address=None, timeout=120.0, process_group=None):
        self.rank = int(rank)
        self.world = int(world)
        self.timeout = timeout
        self._lock = threading.Lock()
        self._peers = {}  # rank -> socket (rank 0 only)
        self._root = None  # socket to rank 0 (peers only)
        self._listener = None
        if self.world > 1:
            self._connect(root_address, process_group)

    # -- wiring ---------------------------------------------------------------

    def _connect(self, root_address, process_group):
        if root_address is None and not _world_up():
            raise RuntimeError(
                "hostreduce needs root_address when torch.distributed "
                "is not initialized"
            )
        if self.rank == 0:
            host, port = self._parse(root_address) if root_address else ("", 0)
            self._listener = socket.create_server((host, port))
            self._listener.settimeout(self.timeout)
            if not root_address:
                _exchange_root("127.0.0.1:{}".format(self._listener.getsockname()[1]), process_group)
            deadline = time.monotonic() + self.timeout
            while len(self._peers) < self.world - 1:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        "hostreduce rank 0: only {}/{} peers joined".format(
                            len(self._peers), self.world - 1
                        )
                    )
                conn, _ = self._listener.accept()
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                (peer_rank,) = _LEN.unpack(_recv_exact(conn, _LEN.size))
                self._peers[int(peer_rank)] = conn
        else:
            if root_address is None:
                root_address = _exchange_root(None, process_group)
            host, port = self._parse(root_address)
            backoff = resilience.Backoff(base=0.05, factor=1.5, max_delay=0.5)
            last_err = None
            for _ in backoff.attempts(resilience.Deadline(self.timeout)):
                try:
                    self._root = socket.create_connection(
                        (host, port), timeout=self.timeout
                    )
                    break
                except OSError as exc:
                    last_err = exc
            else:
                raise TimeoutError(
                    "hostreduce rank {}: root {} unreachable after {}s".format(
                        self.rank, root_address, self.timeout
                    )
                ) from last_err
            self._root.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._root.sendall(_LEN.pack(self.rank))

    @staticmethod
    def _parse(address):
        host, _, port = address.rpartition(":")
        return host or "127.0.0.1", int(port)

    # -- the collective -------------------------------------------------------

    def allreduce_mean(self, buf):
        """Mean of ``buf`` (a 1-D float numpy array) across the group.

        Returns a new array carrying bitwise-identical contents on every
        rank. Timing lands in ``comm_allreduce_seconds_total`` and the
        payload size in the ``comm_bucket_bytes`` gauge, so the comm plane
        shows up in ``TFCluster.metrics()``.
        """
        import numpy as np

        # chaos: one straggler rank's collectives run late — gate on the
        # victim BEFORE rolling the site so healthy ranks consume no budget
        if chaos.active:
            p = chaos.plan()
            spec = p.sites.get("comm.link_delay") if p else None
            if spec is not None and spec.get("victim", self.rank) == self.rank:
                chaos.delay("comm.link_delay")

        t0 = time.perf_counter()
        obs.gauge(
            "comm_bucket_bytes",
            help="payload bytes of the last gradient all-reduce bucket",
        ).set(int(buf.nbytes))
        with self._lock:
            if self.world == 1:
                out = np.array(buf, copy=True)
            elif self.rank == 0:
                acc = np.array(buf, dtype=buf.dtype, copy=True)
                chunks = {}
                for r in self._peers:
                    chunks[r] = np.frombuffer(
                        _recv_msg(self._peers[r]), dtype=buf.dtype
                    )
                for r in sorted(chunks):  # rank order => deterministic sum
                    acc += chunks[r]
                acc /= self.world
                payload = acc.tobytes()
                for r in self._peers:
                    _send_msg(self._peers[r], payload)
                out = acc
            else:
                _send_msg(self._root, np.ascontiguousarray(buf).tobytes())
                out = np.frombuffer(_recv_msg(self._root), dtype=buf.dtype).copy()
        obs.counter(
            "comm_allreduce_seconds_total",
            help="host seconds spent inside gradient all-reduces",
        ).inc(time.perf_counter() - t0)
        return out

    def close(self):
        for s in list(self._peers.values()) + [self._root, self._listener]:
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self._peers.clear()
        self._root = self._listener = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
