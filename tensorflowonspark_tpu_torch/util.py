"""Small host-side utilities shared by driver and executors.

Capability-parity with /root/reference/tensorflowonspark/util.py (IP discovery,
PATH search, executor-id persistence, single-node env setup) but adapted for a
torch runtime: ``single_node_env`` selects the CPU or a CUDA device, and the
executor-id file also records the local IPC manager address so later Spark
tasks landing on the same executor can reconnect to the running trainer
process (reference: util.py:77-86 + TFSparkNode.py:97-123).
"""

import errno
import json
import logging
import multiprocessing
import os
import socket

from tensorflowonspark_tpu_torch import durable

logger = logging.getLogger(__name__)

_mp_spawn = multiprocessing.get_context("spawn")

#: log format carrying process/thread names — the runtime spans a driver,
#: N executor processes and N jax child processes, so bare messages are
#: un-attributable (reference tensorflowonspark/__init__.py:3)
LOG_FORMAT = "%(asctime)s %(levelname)s (%(processName)s %(threadName)s) %(name)s: %(message)s"


def setup_logging(level=logging.INFO):
    """Configure root logging for an APPLICATION entry point (examples,
    bench.py, the jax child process). Libraries must never do this at import
    time — importing :mod:`tensorflowonspark_tpu_torch` leaves the root logger's
    handlers untouched so embedding applications keep control of their own
    logging (enforced by the ``import-hygiene`` rule of ``python -m tosa``
    and a regression test). No-op if the root logger is already configured."""
    logging.basicConfig(level=level, format=LOG_FORMAT)


def _spawn_trampoline(blob):
    import cloudpickle

    cloudpickle.loads(blob)()


def spawn_process(fn, name=None):
    """A ``multiprocessing.Process`` running ``fn()`` in a **spawned** child.

    Spawn (not fork) everywhere: executors, IPC servers, and jax children are
    all started from processes that may carry threads (pytest, jax's own
    thread pools, queue feeders), and forking a threaded process deadlocks —
    python 3.12 warns about exactly this. ``fn`` may be any cloudpickle-able
    zero-arg callable (closures included); a spawned child only needs the
    module-level trampoline to be importable.
    """
    import cloudpickle

    return _mp_spawn.Process(target=_spawn_trampoline, args=(cloudpickle.dumps(fn),), name=name)

# Name of the per-executor state file written into the executor's CWD.
EXECUTOR_STATE_FILE = "tos_tpu_executor.json"


#: the kernel's IPv4 routing table (Linux)
ROUTE_TABLE = "/proc/net/route"


def _default_route_interface(route_table=ROUTE_TABLE):
    """Name of the interface of the lowest-metric IPv4 default route that
    is up, or None (no table, no default route)."""
    try:
        with open(route_table) as f:
            rows = [line.split() for line in f.readlines()[1:]]
    except OSError:
        return None
    defaults = [
        (int(r[6]), r[0]) for r in rows
        # Iface Destination Gateway Flags RefCnt Use Metric Mask ...; RTF_UP = 0x1
        if len(r) > 7 and r[1] == "00000000" and r[7] == "00000000" and int(r[3], 16) & 0x1
    ]
    return min(defaults)[1] if defaults else None


def _interface_address(ifname):
    """The IPv4 address of interface ``ifname`` (``SIOCGIFADDR``); raises
    OSError when it has none."""
    import fcntl
    import struct

    siocgifaddr = 0x8915
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        packed = fcntl.ioctl(s.fileno(), siocgifaddr, struct.pack("256s", ifname[:15].encode()))
    return socket.inet_ntoa(packed[20:24])


def get_ip_address():
    """Best-effort routable IP address of this host.

    The address of the interface that carries the default route, read from
    the routing table (the address the JAX package's UDP-connect probe
    finds, without aiming a socket anywhere), falling back to hostname
    resolution and finally loopback, as there. Reference: util.py:52.
    """
    ifname = _default_route_interface()
    if ifname is not None:
        try:
            return _interface_address(ifname)
        except OSError:
            pass
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def find_in_path(path, file_name):
    """Find a file within a ':'-separated search path (reference util.py:68)."""
    for p in path.split(os.pathsep):
        candidate = os.path.join(p, file_name)
        if os.path.exists(candidate) and os.path.isfile(candidate):
            return candidate
    return False


def write_executor_state(state, cwd=None):
    """Persist per-executor bootstrap state (executor id, IPC manager address,
    authkey) to a file in the executor's working directory.

    The reference persisted just the executor id (util.py:77-82); we persist the
    whole reconnect record because feeding tasks scheduled later onto this
    executor must find the already-running jax process's IPC manager.
    ``authkey`` bytes are hex-encoded.
    """
    record = dict(state)
    if isinstance(record.get("authkey"), bytes):
        record["authkey"] = record["authkey"].hex()
        record["authkey_hex"] = True
    path = os.path.join(cwd or os.getcwd(), EXECUTOR_STATE_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    # reconnect-after-crash reads this record; a torn or vanished file
    # strands later tasks without the running jax child's IPC address
    durable.fsync_dir(os.path.dirname(path))
    return path


def read_executor_state(cwd=None):
    """Read the record written by :func:`write_executor_state`, or None."""
    path = os.path.join(cwd or os.getcwd(), EXECUTOR_STATE_FILE)
    try:
        with open(path) as f:
            record = json.load(f)
    except OSError as e:
        if e.errno in (errno.ENOENT,):
            return None
        raise
    if record.pop("authkey_hex", False):
        record["authkey"] = bytes.fromhex(record["authkey"])
    return record


#: env var carrying the trainer's platform down the cluster's env lane
ENV_PLATFORM = "TOS_PLATFORM"
#: platforms a trainer can run on; "gpu" is the default everywhere
PLATFORMS = ("gpu", "cpu")


def force_platform(platform):
    """Select the device platform for THIS process and its children.

    ``"cpu"`` hides every card (``CUDA_VISIBLE_DEVICES=""``), so it must run
    before torch first touches CUDA; ``"gpu"`` leaves visibility alone and
    is checked when the device is selected (:func:`select_device`).
    """
    if platform not in PLATFORMS:
        raise ValueError("platform must be one of {}, got {!r}".format(PLATFORMS, platform))
    os.environ[ENV_PLATFORM] = platform
    if platform == "cpu":
        os.environ["CUDA_VISIBLE_DEVICES"] = ""


def cpu_share(sharers):
    """This process's share of the cores it may run on when ``sharers``
    processes of the host split them (at least one)."""
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:  # not Linux
        cores = os.cpu_count() or 1
    return max(1, cores // max(1, int(sharers)))


def card_map(executor_ids, cards, lost=()):
    """The cards (CUDA device indices) of the ranks of one world on one host
    with ``cards`` visible cards, as ``{executor_id: card}``.

    A card belongs to an executor, not to a rank (the JAX package's rule: an
    executor owns its chips). Executor ``e``'s own card is ``e % cards``,
    the same in every life of a recovery, so a shrink that renumbers the
    ranks hands no survivor the card of the executor it lost. Where the own
    cards of several executors coincide (ids past the host's cards: the
    chief and a worker beside an evaluator, a spare standing in for a
    blacklisted executor), the lowest id owns the card, the ``lost``
    (blacklisted) executors counted among the owners; every other rank, in
    id order, takes the lowest card that neither a rank nor a lost executor
    owns, else the lowest card no rank holds. A world with more ranks on the
    host than cards raises: NCCL takes one rank of a world on a card.
    """
    cards = int(cards)
    ids = sorted({int(e) for e in executor_ids})
    if len(ids) > cards:
        raise ValueError(
            "{} ranks of one world on a host with {} card(s) (executors {}): "
            "NCCL needs a card for each".format(len(ids), cards, ids)
        )
    owner = {}
    for e in sorted(set(ids) | {int(e) for e in lost}):
        owner.setdefault(e % cards, e)
    placed = {e: e % cards for e in ids if owner[e % cards] == e}
    for e in ids:
        if e not in placed:
            held = set(placed.values())
            free = [c for c in range(cards) if c not in held and c not in owner]
            placed[e] = (free or [c for c in range(cards) if c not in held])[0]
    return placed


def select_device(platform="gpu", index=0):
    """The ``torch.device`` this process trains on.

    ``"gpu"`` takes CUDA device ``index`` (modulo the visible count, so
    co-located processes spread over the host's cards) and makes it current;
    it raises when torch sees no CUDA device, it never falls back to the CPU.
    """
    import torch

    if platform == "cpu":
        return torch.device("cpu")
    if platform != "gpu":
        raise ValueError("platform must be one of {}, got {!r}".format(PLATFORMS, platform))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "platform 'gpu' requested but torch {} (CUDA {}) sees no CUDA device; "
            "pass platform 'cpu' to run on the CPU".format(torch.__version__, torch.version.cuda)
        )
    device = torch.device("cuda", index % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device


def world_size():
    """Ranks of the ``torch.distributed`` world: 1 when none is initialized."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def single_node_env(platform="gpu"):
    """Prepare a *single-node* trainer process and return its device.

    The reference's version wired up the Hadoop classpath and
    CUDA_VISIBLE_DEVICES (util.py:21-49); here it selects the platform
    (:func:`force_platform`) and the device (:func:`select_device`).
    """
    force_platform(platform)
    return select_device(platform)


def find_free_port(host=""):
    """Bind-and-release a TCP port; used for coordinator/profiler ports.

    The reference bound a free port for the TF grpc server
    (TFSparkNode.py:252-255); here ports are needed for the
    torch.distributed rendezvous.
    """
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        return s.getsockname()[1]
