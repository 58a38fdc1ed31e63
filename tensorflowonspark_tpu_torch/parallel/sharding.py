"""Sharding rules: how batches and parameters map onto the mesh — the port
of the JAX package's ``parallel/sharding.py``.

A spec is the JAX ``PartitionSpec`` as a tuple: for each dimension of the
port's tensor, the mesh axis (or tuple of axes) it is split over, or None;
``()`` replicates. A :class:`Sharding` pairs a spec with its mesh, as
``NamedSharding`` does. Batches split their leading dimension over the data
axes (``dp`` × ``fsdp``): each rank is fed its own share, so placing a batch
is a copy to this rank's device. ``sp`` is not a data axis: the ranks of
an ``sp`` group read the same rows, and each takes its block of the
sequence (:func:`sequence_shard`, :func:`sequence_chunk`). Parameters are replicated for pure DP or
sharded along ``fsdp`` (ZeRO-3) with the JAX package's per-array rule,
applied to the flax layout of each parameter (``convert.flax_layouts``) so
that the port shards the same logical dimension the JAX package does.

:class:`ShardedParams` is the ZeRO-3 state of a module: this rank's shard of
each sharded parameter, the master copy its optimizer updates, beside the
module's full parameter storage, which stays resident and is refreshed by
an all-gather after every update.
"""

import collections
import math

import torch

from tensorflowonspark_tpu_torch.parallel import collectives
from tensorflowonspark_tpu_torch.parallel.mesh import mesh_device, mesh_shape


class Sharding(collections.namedtuple("Sharding", "mesh spec")):
    """A spec on a mesh (JAX's ``NamedSharding``)."""


def data_axes(mesh):
    """The mesh axes a batch's leading dim is sharded over."""
    return tuple(a for a in ("dp", "fsdp") if a in mesh.mesh_dim_names)


def batch_spec(mesh):
    """The spec of a batch: leading dim over the data axes."""
    axes = data_axes(mesh)
    if not axes:
        return ()
    return (axes if len(axes) > 1 else axes[0],)


def batch_sharding(mesh):
    return Sharding(mesh, batch_spec(mesh))


def replicated(mesh):
    return Sharding(mesh, ())


def mesh_axis_size(mesh, name):
    return mesh_shape(mesh).get(name, 1)


def _shard(mesh, rank, axes):
    """``(index, count)``: ``rank``'s row-major coordinate over ``axes`` of
    the mesh and their size, read from the mesh's layout alone, so a plan
    (no process groups) answers before the world is joined."""
    names, grid = mesh.mesh_dim_names, mesh.mesh
    where = (grid == rank).nonzero()
    if len(where) != 1:
        raise ValueError("rank {} is not on the mesh {}".format(rank, grid.tolist()))
    index, count = 0, 1
    for a in axes:
        i = names.index(a)
        index, count = index * grid.shape[i] + int(where[0][i]), count * grid.shape[i]
    return index, count


def data_shard(mesh, rank):
    """``(index, count)`` of ``rank``'s share of a batch split over the
    mesh's data axes: its coordinate over them (its rank in their group)
    and their size."""
    return _shard(mesh, rank, data_axes(mesh))


def sequence_shard(mesh, rank=None, axis="sp"):
    """``(index, count)`` of ``rank``'s block of the sequence along the
    mesh's ``axis``: ``(0, 1)`` without one. The one reading of which block
    a rank holds: the data's chunking (:func:`sequence_chunk`), the model's
    default positions and the ring's split all take it here. ``rank`` None
    is this process, whose rank in the axis's process group (the order the
    ring sends in) must then be the same index."""
    axes = [a for a in (axis,) if a in mesh.mesh_dim_names]
    if rank is not None:
        return _shard(mesh, rank, axes)
    import torch.distributed as dist

    index, count = _shard(mesh, dist.get_rank(), axes)
    if count > 1 and dist.get_rank(collectives.axes_group(mesh, axis)) != index:
        raise RuntimeError("rank {} holds block {} of the sequence on the mesh, but is member {} of its {} "
                           "group".format(dist.get_rank(), index, dist.get_rank(collectives.axes_group(mesh, axis)),
                                          axis))
    return index, count


def sequence_chunk(batch, index, count):
    """Block ``index`` of ``count`` of an LM batch's sequence: ``tokens``
    ``[B, L + 1]`` (the inputs are ``tokens[:, :-1]``, the targets
    ``tokens[:, 1:]``) and the ``segment_ids``, ``positions`` and ``mask``
    beside them. Each block of ``c = ceil(L / count)`` inputs takes its
    ``c + 1`` tokens (one overlapping the next block, its last target), so
    the loss's shift by one runs on the block as on the whole row. The last
    block is padded with token 0, segment id 0 and position 0, and a
    ``mask`` of 0 there (added when the batch has none), so its padding is
    neither attended by a real token nor counted in the loss. A padded
    split also carries ``valid``: 1 where a block's token is one of the
    row's inputs, 0 on the padding (the mixture of experts keeps the
    padding out of its balancing loss by it) and ``row_length``, the
    row's inputs as a host ``int``, from which every rank works out each
    block's real count on its own (the mixture of experts' route; batch
    placement keeps host ints on the host). Numpy arrays or tensors;
    ``count`` 1 returns the batch as it is."""
    if count == 1:
        return batch
    import numpy as np

    length = batch["tokens"].shape[1] - 1
    c = -(-length // count)
    out = dict(batch)
    if c * count > length:
        if "mask" not in batch:
            out["mask"] = np.ones(batch["tokens"].shape, np.int32)
        out["valid"] = np.ones(batch["tokens"].shape, np.int32)
        out["valid"][:, length] = 0
    for key, v in out.items():
        v = v[:, index * c:index * c + c + 1]
        if v.shape[1] < c + 1:
            v = np.pad(np.asarray(v), ((0, 0), (0, c + 1 - v.shape[1])))
        out[key] = v
    if "valid" in out:
        out["row_length"] = int(length)
    return out


def data_group(mesh):
    """The process group over the mesh's data axes (the ranks a batch is
    split over; a model axis is never in it)."""
    return collectives.axes_group(mesh, data_axes(mesh))


def _pick_fsdp_axis(shape, axis_size, min_weight_size):
    """Index of the dim to shard along fsdp: the largest dim divisible by the
    axis size, on arrays big enough to be worth sharding; None = replicate."""
    if math.prod(shape) < min_weight_size:
        return None
    best, best_dim = None, -1
    for i, d in enumerate(shape):
        if d % axis_size == 0 and d > best_dim:
            best, best_dim = i, d
    return best


def _layouts(params):
    """``{name: (flax_shape, dims)}`` of a module's parameters
    (``convert.flax_layouts``), or of a ``{name: tensor}`` dict, whose
    tensors are their own layout."""
    if hasattr(params, "named_parameters"):
        from tensorflowonspark_tpu_torch import convert

        return convert.flax_layouts(params)
    return {n: (tuple(t.shape), tuple(range(len(t.shape)))) for n, t in params.items()}


def _to_port(flax_dim, shape, dims):
    """The port's dimension holding flax dimension ``flax_dim``; a minor
    part of a fused dimension under a major part of size > 1 would be
    strided in the port's tensor, which no rule here produces."""
    if any(dims[i] == dims[flax_dim] and shape[i] > 1 for i in range(flax_dim)):
        raise ValueError("flax dim {} of {} is strided in the port's layout".format(flax_dim, shape))
    return dims[flax_dim]


def _spec_axes(spec):
    """Flat set of mesh-axis names a spec already uses."""
    used = set()
    for entry in tuple(spec):
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            used.update(entry)
        else:
            used.add(entry)
    return used


def fsdp_param_specs(params, mesh, min_weight_size=2**14):
    """``{name: spec}`` for a module's parameters (or a ``{name: tensor}``
    dict): fully-shard eligible arrays along the ``fsdp`` axis (ZeRO-3),
    replicate the rest (biases, norm scales, small embeddings). With no
    ``fsdp`` axis in the mesh, everything replicates."""
    layouts = _layouts(params)
    if "fsdp" not in mesh.mesh_dim_names:
        return {n: () for n in layouts}
    axis_size = mesh_axis_size(mesh, "fsdp")
    specs = {}
    for name, (shape, dims) in layouts.items():
        dim = _pick_fsdp_axis(shape, axis_size, min_weight_size)
        if dim is None:
            specs[name] = ()
            continue
        spec = [None] * (max(dims) + 1 if dims else 0)
        spec[_to_port(dim, shape, dims)] = "fsdp"
        specs[name] = tuple(spec)
    return specs


def overlay_fsdp_specs(params, specs, mesh, min_weight_size=2**14):
    """Overlay ZeRO-3 sharding onto an existing ``{name: spec}``.

    The composition rule for hybrid dp×fsdp(×tp) meshes: a model's own
    placement wins where it already touches the ``fsdp`` axis; every other
    array big enough to be worth sharding gets its largest still-unclaimed
    (flax) dim sharded along ``fsdp``. With no ``fsdp`` axis in the mesh
    this is the identity."""
    if "fsdp" not in mesh.mesh_dim_names:
        return dict(specs)
    axis_size = mesh_axis_size(mesh, "fsdp")
    out = {}
    for name, (shape, dims) in _layouts(params).items():
        s = tuple(specs[name])
        out[name] = s
        if "fsdp" in _spec_axes(s) or math.prod(shape) < min_weight_size:
            continue
        entries = list(s) + [None] * (max(dims) + 1 - len(s))
        best, best_dim = None, -1
        for i, d in enumerate(shape):
            if entries[dims[i]] is None and d % axis_size == 0 and d > best_dim:
                best, best_dim = i, d
        if best is not None:
            entries[_to_port(best, shape, dims)] = "fsdp"
            out[name] = tuple(entries)
    return out


def block(x, spec, mesh):
    """This rank's block of the full tensor ``x`` under ``spec`` on
    ``mesh`` (a view)."""
    for d, entry in enumerate(spec):
        if entry:
            x = x.chunk(collectives.axis_size(entry, mesh), d)[collectives.axis_index(entry, mesh)]
    return x


def place(x, sharding):
    """This rank's block of the full host tensor ``x`` under ``sharding``,
    on the mesh's device (a copy). Anything but a tensor passes through."""
    if not isinstance(x, torch.Tensor):
        return x
    mesh, spec = sharding
    return block(x, spec, mesh).to(mesh_device(mesh), copy=True).contiguous()


def shard_params(params, mesh, specs=None):
    """This rank's blocks of a ``{name: tensor}`` dict (default specs: the
    ZeRO-3 rule)."""
    if specs is None:
        specs = fsdp_param_specs(params, mesh)
    return {n: place(t, Sharding(mesh, specs[n])) for n, t in params.items()}


def shard_batch(batch, mesh):
    """Place this rank's share of the global batch (numpy arrays or
    tensors) on the mesh's device: each rank is fed its own rows, so the
    leading dim is already split over the data axes."""
    device = mesh_device(mesh)
    return {k: v if isinstance(v, int) else torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


class ShardedParams:
    """ZeRO-3 along ``fsdp``: for each parameter whose spec names
    ``fsdp``, this rank's shard along that dimension (a tensor of its own,
    the master copy the optimizer updates) and the collectives between the
    shards and the module's full parameters.

    * :meth:`reduce_grads`: each sharded gradient is reduce-scattered over
      ``fsdp``, the shards all-reduced over ``dp``; each replicated
      gradient, and the metrics, all-reduced over the data axes; all
      divided by the data axes' size (the loss is a mean over the global
      batch). On a sequence split over ``sp`` every gradient is first
      summed over it (each rank's is its tokens' share).
    * :meth:`gather`: each updated shard is all-gathered over ``fsdp``
      into the module's parameter, in place (through a staging buffer when
      the dimension is not the leading one), so the full parameters are
      current between steps — eval, predict and checkpoints read them.

    The reduce-scatters and all-gathers run whatever the size of ``fsdp``
    (at one rank each moves the bytes as they are), so one code path runs
    at world 1 and at world N; the all-reduces and the division are left
    out where their group holds one rank, as the data-parallel step leaves
    them out. A captured CUDA graph holds every call.
    """

    def __init__(self, module, mesh, specs):
        import torch.distributed as dist

        self.mesh, self.specs = mesh, specs
        self.dims = {n: s.index("fsdp") for n, s in specs.items() if "fsdp" in s}
        self.names = set(specs)
        self.fsdp_group = mesh.get_group("fsdp")
        self.dp_group = mesh.get_group("dp") if "dp" in mesh.mesh_dim_names else None
        self.data_group = data_group(mesh)
        self.n = dist.get_world_size(self.fsdp_group)
        self.data_size = math.prod(mesh_axis_size(mesh, a) for a in data_axes(mesh))
        self.sp_group = mesh.get_group("sp") if mesh_axis_size(mesh, "sp") > 1 else None
        params = dict(module.named_parameters())
        self.full = {n: params[n] for n in self.dims}
        with torch.no_grad():
            self.shards = {n: self.local(params[n], n) for n in self.dims}

    def local(self, full, name):
        """This rank's block of the full tensor ``full`` of parameter ``name``
        (a contiguous copy on the mesh's device)."""
        return place(full.detach(), Sharding(self.mesh, self.specs[name]))

    def optimizer_params(self, module):
        """``{name: tensor}`` the optimizer updates: the shards, and the
        replicated parameters themselves."""
        return {n: self.shards.get(n, p) for n, p in module.named_parameters()}

    def _scatter(self, name, grad):
        d = self.dims[name]
        blocks = grad.unflatten(d, (self.n, grad.shape[d] // self.n)).movedim(d, 0)
        return collectives.scatter_blocks(blocks, self.fsdp_group)

    def reduce_grads(self, grads, metrics):
        """``grads``: ``{name: full gradient}`` → ``{name: gradient of what
        the optimizer updates}``, averaged over the data axes; returns it
        and the averaged metrics."""
        if self.sp_group is not None:
            _all_reduce_sum(list(grads.values()), {}, self.sp_group)
        shard_grads = {n: self._scatter(n, grads[n]) for n in self.dims}
        out = dict(grads)
        out.update(shard_grads)
        if self.data_size == 1:
            return out, metrics
        if self.dp_group is not None and self.data_size > self.n:
            _all_reduce_sum(list(shard_grads.values()), {}, self.dp_group)
        replicated = [grads[n] for n in grads if n not in self.dims]
        metrics = _all_reduce_sum(replicated, metrics, self.data_group)
        for g in list(shard_grads.values()) + replicated:
            g /= self.data_size
        return out, {k: v / self.data_size for k, v in metrics.items()}

    def gather(self):
        """All-gather every shard into its full parameter, in place."""
        import torch.distributed as dist

        with torch.no_grad():
            for name, shard in self.shards.items():
                full, d = self.full[name], self.dims[name]
                if d == 0:
                    dist.all_gather_into_tensor(full.view(-1), shard.view(-1), group=self.fsdp_group)
                else:
                    full.copy_(self.gather_full(name, shard))

    def gather_full(self, name, shard):
        """A new full tensor from every rank's ``shard`` of parameter
        ``name`` (collective)."""
        d = self.dims[name]
        return collectives.gather_blocks(shard, self.fsdp_group).movedim(0, d).flatten(d, d + 1)

    def _map_param_like(self, tree, fn):
        return _map_param_like(tree, self.names, self.dims, fn)

    def full_tree(self, opt_state):
        """``opt_state`` with each sharded slot gathered to full size
        (collective: every rank calls it)."""
        return self._map_param_like(opt_state, self.gather_full)

    def full_shapes(self, opt_state):
        """``opt_state`` with each sharded slot as a meta tensor of its full
        shape: the tree a checkpoint's must fit."""
        return self._map_param_like(opt_state, lambda n, t: t.new_empty(self.full[n].shape, device="meta"))

    def local_tree(self, opt_state):
        """A full-size ``opt_state`` (a checkpoint's) cut to this rank's
        shards."""
        return self._map_param_like(opt_state, lambda n, t: self.local(t, n))

    def reload(self):
        """Refresh the shards from the module's full parameters, in place
        (after a restore wrote them)."""
        with torch.no_grad():
            for name, shard in self.shards.items():
                shard.copy_(self.local(self.full[name], name))


def _map_param_like(tree, names, cut, fn):
    """``tree`` with ``fn(name, tensor)`` applied to the entries named in
    ``cut`` of every dict keyed by the module's parameter ``names`` (the
    parameters, and the optimizer's per-parameter slots, matched
    structurally as the JAX package's ``_opt_shardings`` does)."""
    if isinstance(tree, dict):
        if set(tree) == names:
            return {k: fn(k, v) if k in cut else v for k, v in tree.items()}
        return {k: _map_param_like(v, names, cut, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_param_like(v, names, cut, fn) for v in tree)
    return tree


def _entry_axes(entry):
    return () if not entry else ((entry,) if isinstance(entry, str) else tuple(entry))


def model_spec(spec):
    """The entries of ``spec`` that name a model axis (any axis but the
    data axes ``dp`` and ``fsdp``): the block a model built on the mesh
    holds itself."""
    return tuple(e if _entry_axes(e) and not set(_entry_axes(e)) & {"dp", "fsdp"} else None
                 for e in tuple(spec))


def data_spec(spec):
    """The entries of ``spec`` that name a data axis: what the strategy
    shards of the model's block (ZeRO-3 along ``fsdp``)."""
    return tuple(e if _entry_axes(e) and set(_entry_axes(e)) <= {"dp", "fsdp"} else None
                 for e in tuple(spec))


class ModelShards:
    """The blocks of a module built on a mesh (``create_model(mesh=...)``):
    for each parameter whose spec names a model axis (``tp``, ``ep``), the
    module holds this rank's block along it, and this object moves between
    those blocks and the full tensors. A checkpoint holds full tensors on
    any mesh (:meth:`full_tree` gathers, collectively; :meth:`local_tree`
    cuts), and :meth:`broadcast` makes each block equal on the ranks that
    hold the same one."""

    def __init__(self, module, mesh, specs):
        self.mesh = mesh
        self.names = set(specs)
        #: {name: the model-axis entries of its spec}, for the split parameters
        self.specs = {n: model_spec(s) for n, s in specs.items() if any(model_spec(s))}
        params = dict(module.named_parameters())
        self.shapes = {n: tuple(params[n].shape) for n in self.specs}

    def _cuts(self, name):
        return [(d, axis) for d, axis in enumerate(self.specs.get(name, ())) if axis]

    def full_shape(self, name):
        shape = list(self.shapes[name])
        for d, axis in self._cuts(name):
            shape[d] *= collectives.axis_size(axis, self.mesh)
        return tuple(shape)

    def local(self, full, name):
        """This rank's block of the full tensor of parameter ``name`` (a
        contiguous copy, where ``full`` lies)."""
        return block(full, self.specs[name], self.mesh).contiguous().clone()

    @torch.no_grad()
    def gather_full(self, name, block):
        """A new full tensor from every rank's ``block`` of parameter
        ``name`` (collective over its model axes)."""
        block = block.detach()
        for d, axis in self._cuts(name):
            block = collectives.gather_blocks(block, collectives.axes_group(self.mesh, axis)) \
                .movedim(0, d).flatten(d, d + 1)
        return block

    def full_tree(self, tree):
        """``tree`` (the parameters, or the optimizer state) with each block
        gathered to full size (collective: every rank calls it)."""
        return _map_param_like(tree, self.names, self.specs, self.gather_full)

    def full_shapes(self, tree):
        """``tree`` with each block as a meta tensor of its full shape."""
        return _map_param_like(tree, self.names, self.specs,
                               lambda n, t: t.new_empty(self.full_shape(n), device="meta"))

    def local_tree(self, tree):
        """A full-size tree (a checkpoint's) cut to this rank's blocks."""
        return _map_param_like(tree, self.names, self.specs, lambda n, t: self.local(t, n))

    @torch.no_grad()
    def broadcast(self, module):
        """Make every parameter and buffer equal to the first rank's among
        the ranks that hold the same block of it (the mesh's other axes),
        as ``create_state`` broadcasts a replicated model from rank 0."""
        import torch.distributed as dist

        names = self.mesh.mesh_dim_names
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            own = {a for _, axis in self._cuts(name) for a in _entry_axes(axis)}
            others = tuple(a for a in names if a not in own)
            if not others or collectives.axis_size(others, self.mesh) == 1:
                continue
            group = collectives.axes_group(self.mesh, others)
            dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)


def _all_reduce_sum(tensors, metrics, group):
    """Sum ``tensors`` (in place) and ``metrics`` over ``group`` with one
    all-reduce of a flattened buffer, the metrics in its tail. Returns the
    summed metrics (new tensors)."""
    import torch.distributed as dist

    if not tensors and not metrics:
        return {}
    ref = tensors[0] if tensors else next(iter(metrics.values()))
    dtype, device = (ref.dtype if tensors else torch.float32), ref.device
    values = {k: torch.as_tensor(v, device=device) for k, v in metrics.items()}
    flat = torch.cat([t.reshape(-1) for t in tensors] + [v.reshape(-1).to(dtype) for v in values.values()])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n
    out = {}
    for k, v in values.items():
        n = v.numel()
        got = flat[offset:offset + n].view(v.shape)
        out[k] = (got.to(v.dtype) if v.dtype.is_floating_point else got).clone()
        offset += n
    return out
