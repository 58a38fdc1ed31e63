"""Device meshes over ``torch.distributed`` ranks — the port of the JAX
package's ``parallel/mesh.py``.

In the port one process drives one card, so a mesh is a grid of **ranks**:
each builder returns a :class:`torch.distributed.device_mesh.DeviceMesh`
whose ``mesh_dim_names`` follow :data:`AXIS_ORDER`, and whose ``devices``
attribute holds the grid of rank descriptors it was built from (the JAX
mesh's ``devices``). JAX's single-process mesh over many local devices has
no counterpart: a process's "local" mesh is the world of that one process
(:func:`local_mesh`). The axis arithmetic and the grid are the JAX
package's, copied; where a TPU device carries ``slice_index`` (slices joined
by the slow DCN), a rank carries its ``host`` (cards joined by PCIe/network
across hosts, by NVLink within one), so :func:`build_hybrid_mesh` puts
``dp`` across hosts and keeps ``fsdp``/``tp``/``sp`` on one host's NVLink.

A builder called with no ``devices`` takes the live world's ranks
(:func:`world_devices`), joining a one-rank world first when none is up
(NCCL on the card, gloo on the CPU), so a single process needs no
``init_process_group`` of its own. Ranks given explicitly while no world is
up describe a placement plan: the mesh then carries no process groups (the
tests draw such plans with fake ranks).
"""

import collections
import logging
import math

logger = logging.getLogger(__name__)

#: canonical axis order; meshes are always built with axes in this order so
#: the innermost (fastest-varying) axes ride the fastest links.
AXIS_ORDER = ("dp", "fsdp", "tp", "sp", "ep", "pp")


class RankDevice(collections.namedtuple("RankDevice", "rank host")):
    """One process of the world (one card): its rank and its host."""


def _normalize_axes(axes, num_devices):
    """Resolve an axes spec into an ordered {name: size} with product == num_devices.

    ``axes`` may be None (pure dp), a dict (one size may be -1 = "fill"), or a
    sequence of (name, size) pairs. Unknown axis names are allowed (appended
    after the canonical ones, in given order) so user code can define custom
    axes (e.g. a "stage" axis for pipeline parallelism).
    """
    if axes is None:
        axes = {"dp": -1}
    if not isinstance(axes, dict):
        axes = dict(axes)
    known = [a for a in AXIS_ORDER if a in axes]
    extra = [a for a in axes if a not in AXIS_ORDER]
    ordered = known + extra

    fills = [a for a in ordered if axes[a] == -1]
    if len(fills) > 1:
        raise ValueError("at most one axis may have size -1 (got {})".format(fills))
    fixed = math.prod(axes[a] for a in ordered if axes[a] != -1)
    if fills:
        if num_devices % fixed != 0:
            raise ValueError(
                "cannot fill axis {!r}: {} devices not divisible by {}".format(
                    fills[0], num_devices, fixed
                )
            )
        axes = dict(axes)
        axes[fills[0]] = num_devices // fixed
        fixed = num_devices
    if fixed != num_devices:
        raise ValueError(
            "mesh axes {} use {} devices but {} are available".format(
                {a: axes[a] for a in ordered}, fixed, num_devices
            )
        )
    return {a: axes[a] for a in ordered}


def _slice_groups(devices):
    """Group ranks by ``host``: {host: [devices]} in order of first
    appearance, devices keeping their given order within each host (so
    ranks given in order rise along every mesh axis). Devices with no
    ``host`` attribute all land in one group keyed ``None``."""
    groups = {}
    for d in devices:
        groups.setdefault(getattr(d, "host", None), []).append(d)
    return groups


def _hybrid_factors(shape, n_slices, dcn_axes):
    """Split each mesh axis into (dcn_factor, ici_factor) with
    ``prod(dcn_factors) == n_slices``.

    ``dcn_axes`` may be a dict {axis: dcn_factor} (explicit split) or a
    sequence of axis names eligible to absorb the cross-host dimension — the
    whole ``n_slices`` factor goes to the first eligible axis whose size it
    divides (``dp`` by default), so a flat ``{"dp": 8}`` over 2 hosts
    becomes dp = 2 (across hosts, outer) x 4 (within a host, inner).
    """
    if isinstance(dcn_axes, dict):
        factors = {a: int(dcn_axes.get(a, 1)) for a in shape}
        bad = [a for a in factors if shape[a] % factors[a] != 0]
        if bad:
            raise ValueError(
                "dcn factor does not divide axis size for {}".format(
                    {a: (factors[a], shape[a]) for a in bad}
                )
            )
        if math.prod(factors.values()) != n_slices:
            raise ValueError(
                "dcn factors {} must multiply to the slice count {}".format(
                    factors, n_slices
                )
            )
        return factors
    factors = {a: 1 for a in shape}
    for a in dcn_axes:
        if a in shape and shape[a] % n_slices == 0:
            factors[a] = n_slices
            return factors
    raise ValueError(
        "no axis in {} (sizes {}) can absorb the DCN dimension of {} slices".format(
            tuple(dcn_axes), dict(shape), n_slices
        )
    )


def _hybrid_device_grid(shape, dcn_factors, groups):
    """Device ndarray for a hybrid mesh: host-major within every axis.

    Each axis of size ``s`` splits as ``d x i`` (``d`` = its cross-host
    factor): the grid is built as ``[d0, d1, ..., i0, i1, ...]`` — per-host
    blocks reshaped to the inner dims, stacked over the outer dims — then the
    paired dims are interleaved and merged, so walking any mesh axis visits
    all of a host's ranks before crossing to another host. Pure numpy over
    opaque device objects, so tests can drive it with fakes.
    """
    import numpy as np

    ordered = list(shape)
    dcn_dims = tuple(dcn_factors[a] for a in ordered)
    ici_dims = tuple(shape[a] // dcn_factors[a] for a in ordered)
    per_slice = math.prod(ici_dims)
    blocks = []
    for idx, devs in groups.items():
        if len(devs) != per_slice:
            raise ValueError(
                "slice {} has {} devices; hybrid mesh needs {} per slice".format(
                    idx, len(devs), per_slice
                )
            )
        block = np.empty(per_slice, dtype=object)
        block[:] = devs
        blocks.append(block.reshape(ici_dims))
    grid = np.stack(blocks).reshape(dcn_dims + ici_dims)
    n = len(ordered)
    perm = [k for pair in ((i, n + i) for i in range(n)) for k in pair]
    return grid.transpose(perm).reshape(tuple(shape.values()))


def _live():
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def ensure_world(device_type="cuda"):
    """Join a one-rank world (NCCL on the card, gloo on the CPU) when no
    ``torch.distributed`` world is up; a no-op otherwise. The rendezvous is
    an in-process store: nothing listens on a port."""
    import torch.distributed as dist

    if _live():
        return
    if device_type == "cuda":
        from tensorflowonspark_tpu_torch import util

        util.select_device("gpu")  # raises without a card
    elif device_type != "cpu":
        raise ValueError("device_type must be 'cuda' or 'cpu', got {!r}".format(device_type))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def world_devices():
    """The live world's ranks as :class:`RankDevice`, each with the host
    it runs on (one gather of host names)."""
    import socket

    import torch.distributed as dist

    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    return [RankDevice(r, h) for r, h in enumerate(hosts)]


def _rank_of(device):
    return device if isinstance(device, int) else device.rank


def _device_mesh(grid, names, device_type, plan=False):
    """A DeviceMesh over ``grid`` (an ndarray of ranks or rank descriptors),
    its groups created when a world is up (on the world's backend) unless
    ``plan``, and ``mesh.devices = grid``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.tensor(np.vectorize(_rank_of, otypes=[np.int64])(grid), dtype=torch.int)
    if _live() and not plan:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        mesh = DeviceMesh(device_type, ranks, mesh_dim_names=names)
    else:  # a placement plan: no process groups
        mesh = DeviceMesh(device_type, ranks, mesh_dim_names=names, _init_backend=False, _rank=0)
    mesh.devices = grid
    return mesh


def build_hybrid_mesh(axes=None, devices=None, dcn_axes=("dp",), drop_trivial=False, device_type="cuda",
                      plan=False):
    """Build a host-topology-aware mesh: cross-host axes outer, NVLink axes
    inner.

    On worlds whose ranks run on more than one host, collectives along an
    axis that spans hosts pay the slower network hop, so the data-parallel
    axis should cross hosts while fsdp/tp/sp stay inside one host.
    ``dcn_axes`` names the axes allowed to absorb the cross-host dimension
    (first fit wins; pass a ``{axis: factor}`` dict to split explicitly).
    ``axes=None`` defaults to ``{"dp": n_hosts, "fsdp": -1}`` — dp across
    hosts, params fully sharded within each host.

    Single-host (or host-unaware) rank sets delegate straight to
    :func:`build_mesh`; otherwise the grid is assembled host-major by
    :func:`_hybrid_device_grid`.
    """
    if devices is None:
        ensure_world(device_type)
        devices = world_devices()
    groups = _slice_groups(devices)
    if len(groups) <= 1:
        return build_mesh(axes, devices, drop_trivial, device_type, plan=plan)
    n_slices = len(groups)
    if axes is None:
        axes = {"dp": n_slices, "fsdp": -1}
    shape = _normalize_axes(axes, len(devices))
    factors = _hybrid_factors(shape, n_slices, dcn_axes)
    if drop_trivial:
        kept = {a: s for a, s in shape.items() if s > 1} or {"dp": 1}
        if any(factors[a] > 1 for a in shape if a not in kept):
            raise ValueError("cannot drop a trivial axis carrying a DCN factor")
        shape = kept
        factors = {a: factors[a] for a in shape}
    grid = _hybrid_device_grid(shape, factors, groups)
    logger.info("hybrid mesh: %s over %d host(s), cross-host factors %s", shape, n_slices, factors)
    return _device_mesh(grid, tuple(shape), device_type, plan)


def build_mesh(axes=None, devices=None, drop_trivial=False, device_type="cuda", plan=False):
    """Build a :class:`~torch.distributed.device_mesh.DeviceMesh` with named
    axes over the ranks (a plain reshape of ``devices``, in rank order).

    ``axes``: dict of axis name → size; one size may be -1 ("use remaining
    ranks"); default ``{"dp": -1}``. ``drop_trivial`` removes size-1 axes.
    ``devices``: the ranks (ints or :class:`RankDevice`); default the live
    world's, joining a one-rank world on ``device_type`` when none is up.
    Ranks on more than one host delegate to :func:`build_hybrid_mesh`; only
    if no axis can absorb the host dimension does the flat reshape run
    (with a warning). ``plan`` builds the layout alone, with no process
    groups, even in a live world (building a mesh is otherwise collective).
    """
    if devices is None:
        ensure_world(device_type)
        devices = world_devices()
    if len(_slice_groups(devices)) > 1:
        try:
            return build_hybrid_mesh(axes, devices, drop_trivial=drop_trivial, device_type=device_type,
                                     plan=plan)
        except ValueError as e:
            logger.warning(
                "hybrid mesh placement failed (%s); flat reshape: inner-axis "
                "collectives will cross hosts", e)
    import numpy as np

    shape = _normalize_axes(axes, len(devices))
    if drop_trivial:
        shape = {a: s for a, s in shape.items() if s > 1} or {"dp": 1}
    grid = np.empty(len(devices), dtype=object)
    grid[:] = list(devices)
    logger.info("mesh: %s over %d rank(s)", shape, len(devices))
    return _device_mesh(grid.reshape(tuple(shape.values())), tuple(shape), device_type, plan)


def local_mesh(axes=None, device_type="cuda"):
    """Mesh over this process's card alone: the world of one process,
    joined here when none is up. A world of more ranks raises (use
    :func:`build_mesh` or ``ctx.mesh``): one process drives one card."""
    import torch.distributed as dist

    ensure_world(device_type)
    if dist.get_world_size() != 1:
        raise ValueError(
            "local_mesh is the one-process mesh; this world has {} ranks: use "
            "build_mesh or ctx.mesh".format(dist.get_world_size()))
    return build_mesh(axes, world_devices(), device_type=device_type)


def mesh_shape(mesh):
    """{axis: size} for a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_device(mesh):
    """The ``torch.device`` this process's work on ``mesh`` runs on: its
    current CUDA device, or the CPU."""
    import torch

    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
