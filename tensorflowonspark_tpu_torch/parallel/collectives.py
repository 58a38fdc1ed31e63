"""Collectives over mesh axes — the port of the JAX package's
``parallel/collectives.py``.

The JAX package calls its collectives inside ``shard_map`` bodies, where an
axis name stands for the devices along it. The port has no ``shard_map``:
its code already runs once per rank (one process a card), so each call here
is an eager ``torch.distributed`` collective over the process group of the
named mesh axis (``mesh.get_group(axis)``; a tuple of axes is one group of
the ranks that differ only along those axes, in row-major order). Inputs are
this rank's block; every function returns a new tensor and leaves its input
as it was, as the JAX primitives do.

JAX / XLA primitive     → torch.distributed on the axis's group
---------------------     ------------------------------------------
psum / pmean            → all_reduce (sum; the mean divides by the size)
all_gather              → all_gather_into_tensor
psum_scatter            → reduce_scatter_tensor
ppermute (ring)         → batch_isend_irecv with the axis's neighbours
all_to_all              → all_to_all_single
axis_index / axis_size  → the rank within, and the size of, the group

The group's rank order is its ranks' order, which the mesh builders keep
rising along every axis, so ``axis_index`` is the mesh coordinate.

The process's *data group* (:func:`set_data_group`) is the group its batch
is split over — ``dp`` × ``fsdp`` of the strategy's mesh, never a model
axis. Global BatchNorm statistics (``ops/fused_bn.py``) reduce over it;
with none set it is the whole world.
"""

import math


def _groups(mesh):
    groups = getattr(mesh, "_tos_groups", None)
    if groups is None:
        groups = mesh._tos_groups = {}
    return groups


def axes_group(mesh, axes):
    """The process group of this rank along ``axes`` (an axis name or a
    tuple of them). A tuple's groups are created once per mesh, by every
    rank (``new_group`` is collective); one that holds the whole world in
    rank order is the world's group."""
    import torch.distributed as dist

    if isinstance(axes, str):
        return mesh.get_group(axes)
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = _groups(mesh)
    if axes not in cache:
        names = mesh.mesh_dim_names
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError("axes {} not in the mesh's {}".format(missing, names))
        inner = [names.index(a) for a in axes]
        outer = [i for i in range(len(names)) if i not in inner]
        grid = mesh.mesh.permute(outer + inner)
        rows = grid.reshape(-1, math.prod(grid.shape[len(outer):])).tolist()
        me, mine = dist.get_rank(), None
        for row in rows:
            if row == list(range(dist.get_world_size())):
                group = dist.group.WORLD
            else:
                group = dist.new_group(row)
            if me in row:
                mine = group
        cache[axes] = mine
    return cache[axes]


def gather_blocks(x, group):
    """``[n, *x.shape]``: every member's ``x`` in the group's order, by one
    ``all_gather_into_tensor`` (in the flat, concatenated form that every
    backend takes)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    out = x.new_empty((n * x.numel(),))
    dist.all_gather_into_tensor(out, x.contiguous().reshape(-1), group=group)
    return out.view((n,) + tuple(x.shape))


def scatter_blocks(blocks, group):
    """Member i's block of the sum of ``blocks`` (``[n, ...]``, one block a
    member) over the group, by one ``reduce_scatter_tensor``."""
    import torch.distributed as dist

    out = blocks.new_empty(blocks.shape[1:])
    dist.reduce_scatter_tensor(out.view(-1), blocks.contiguous().reshape(-1), group=group)
    return out


_DATA = {"group": None}


def set_data_group(group):
    """Make ``group`` the process's data group (None: the world)."""
    _DATA["group"] = group


def data_group():
    """The process's data group (None stands for the world)."""
    return _DATA["group"]


def data_size():
    """Ranks in the process's data group: 1 when no world is up."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(_DATA["group"])


def psum(x, axis_name, mesh):
    """All-reduce sum over a mesh axis (NCCL allreduce)."""
    import torch.distributed as dist

    out = x.clone()
    dist.all_reduce(out, group=axes_group(mesh, axis_name))
    return out


def pmean(x, axis_name, mesh):
    """All-reduce mean — gradient averaging for sync data parallelism."""
    return psum(x, axis_name, mesh) / axis_size(axis_name, mesh)


def all_gather(x, axis_name, mesh, axis=0, tiled=True):
    """Gather the blocks of every member of the axis (NCCL allgather):
    concatenated along ``axis`` (``tiled``) or stacked on a new ``axis``."""
    out = gather_blocks(x, axes_group(mesh, axis_name)).movedim(0, axis)
    return out.flatten(axis, axis + 1) if tiled else out


def reduce_scatter(x, axis_name, mesh, scatter_dimension=0, tiled=True):
    """Reduce-then-scatter (NCCL reducescatter), the building block of ZeRO
    gradient sharding: member i keeps block i of the sum along
    ``scatter_dimension`` (``tiled``), or, untiled, row i of a dimension of
    the axis's size, which drops out."""
    n, d = axis_size(axis_name, mesh), scatter_dimension
    if tiled:
        blocks = x.unflatten(d, (n, x.shape[d] // n)).movedim(d, 0)
    else:
        if x.shape[d] != n:
            raise ValueError("untiled reduce_scatter needs dimension {} of size {}, got {}".format(
                d, n, x.shape[d]))
        blocks = x.movedim(d, 0)
    return scatter_blocks(blocks, axes_group(mesh, axis_name))


def ring_shift(x, axis_name, mesh, shift=1):
    """Rotate blocks around the axis ring: member i's value goes to
    i + shift. The pattern behind ring attention and pipelined collectives;
    on one host it rides the NVLink neighbours."""
    import torch
    import torch.distributed as dist

    group = axes_group(mesh, axis_name)
    n, me = dist.get_world_size(group), dist.get_rank(group)
    if shift % n == 0:
        return x.clone()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(group, (me + shift) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (me - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def all_to_all(x, axis_name, mesh, split_axis, concat_axis):
    """All-to-all — the Ulysses-style sequence-parallel exchange and the MoE
    expert dispatch: ``x`` splits along ``split_axis`` into one block a
    member, and the blocks received are concatenated along ``concat_axis``
    in the members' order (JAX's ``tiled=True``)."""
    import torch
    import torch.distributed as dist

    n = axis_size(axis_name, mesh)
    blocks = x.unflatten(split_axis, (n, x.shape[split_axis] // n)).movedim(split_axis, 0).contiguous()
    out = torch.empty_like(blocks)
    dist.all_to_all_single(out, blocks, group=axes_group(mesh, axis_name))
    return torch.cat(out.unbind(0), dim=concat_axis)


def axis_index(axis_name, mesh):
    """This rank's index along the axis."""
    import torch.distributed as dist

    return dist.get_rank(axes_group(mesh, axis_name))


def axis_size(axis_name, mesh):
    """Members of the axis (the product of the sizes for a tuple)."""
    names = mesh.mesh_dim_names
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    return math.prod(mesh.mesh.shape[names.index(a)] for a in axes)


# -- Collectives that carry a gradient ------------------------------------
#
# The functions above have no backward. A layer split over a model axis
# (tensor parallelism over ``tp``, experts over ``ep``) needs the conjugate
# pairs of Megatron-LM, where each collective's backward is the transpose
# of its forward over the same group:
#
#   copy_to_region      identity            | all-reduce of the gradient
#   reduce_from_region  all-reduce (sum)    | identity
#   gather_from_region  all-gather on dim   | this rank's slice of the gradient
#   split_to_region     this rank's slice   | all-gather of the gradient
#   global_sum          all-reduce (sum)    | all-reduce of the gradient
#
# A region opens with ``copy_to_region`` on its input (each rank's part of
# the layer back-propagates a partial gradient into it) and closes with
# ``reduce_from_region`` on its partial output (or ``gather_from_region``
# on an output split along a dim). ``split_to_region`` cuts a tensor
# every rank holds whole into this rank's slice, as ring attention takes
# its block of the sequence. ``global_sum`` is a statistic of the
# data axes that every rank's loss uses, as the MoE balancing loss does:
# the strategy averages the ranks' gradients, so each rank's share of it
# must carry the sum of theirs. At a group of one rank every function
# moves the bytes as they are. ``group`` None is the world.


def _autograd():
    """The region functions, made at first use (the module imports no
    torch)."""
    fns = _AUTOGRAD.get("fns")
    if fns is not None:
        return fns
    import torch
    import torch.distributed as dist

    def all_reduce(x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    class CopyToRegion(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group):
            ctx.group = group
            return x.view_as(x)

        @staticmethod
        def backward(ctx, grad):
            return all_reduce(grad, ctx.group), None

    class ReduceFromRegion(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group):
            return all_reduce(x, group)

        @staticmethod
        def backward(ctx, grad):
            return grad, None

    class GatherFromRegion(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group, dim):
            d = dim % x.dim()
            ctx.dim, ctx.rank = d, dist.get_rank(group)
            ctx.n = dist.get_world_size(group)
            return gather_blocks(x, group).movedim(0, d).flatten(d, d + 1)

        @staticmethod
        def backward(ctx, grad):
            return grad.chunk(ctx.n, ctx.dim)[ctx.rank].contiguous(), None, None

    class SplitToRegion(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group, dim):
            d = dim % x.dim()
            ctx.group, ctx.dim = group, d
            return x.chunk(dist.get_world_size(group), d)[dist.get_rank(group)].contiguous()

        @staticmethod
        def backward(ctx, grad):
            d = ctx.dim
            return gather_blocks(grad.contiguous(), ctx.group).movedim(0, d).flatten(d, d + 1), None, None

    class GlobalSum(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group):
            ctx.group = group
            return all_reduce(x, group)

        @staticmethod
        def backward(ctx, grad):
            return all_reduce(grad, ctx.group), None

    fns = _AUTOGRAD["fns"] = (CopyToRegion.apply, ReduceFromRegion.apply, GatherFromRegion.apply,
                              GlobalSum.apply, SplitToRegion.apply)
    return fns


_AUTOGRAD = {}


def copy_to_region(x, group):
    """``x`` as it is; the backward sums the gradient over ``group``."""
    return _autograd()[0](x, group)


def reduce_from_region(x, group):
    """The sum of every member's ``x`` over ``group``; the backward passes
    the gradient as it is."""
    return _autograd()[1](x, group)


def gather_from_region(x, group, dim=-1):
    """Every member's ``x`` concatenated along ``dim`` in the group's
    order; the backward keeps this rank's slice of the gradient (no sum)."""
    return _autograd()[2](x, group, dim)


def split_to_region(x, group, dim=-1):
    """This rank's slice of ``x`` (which every member holds whole) along
    ``dim``, in the group's order; the backward gathers every member's
    slice of the gradient, so the input's gradient is whole."""
    return _autograd()[4](x, group, dim)


def global_sum(x, group):
    """The sum of every member's ``x`` over ``group``; the backward sums the
    gradient over the group too."""
    return _autograd()[3](x, group)
