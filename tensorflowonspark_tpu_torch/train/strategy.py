"""Synchronous data parallelism over ``torch.distributed`` — the port of the
JAX package's ``train/strategy.py``.

There the strategy owns a device mesh and XLA derives the collectives from
shardings. Here each process owns one device. Given a device, every process
holds a full replica: batches are placed on it, and with more than one
process the gradients, the loss and the aux metrics are averaged with one
all-reduce per step before the optimizer runs, so every replica takes the
same update, parameters stay bit-identical across ranks, and every rank
reports the global batch's loss. BatchNorm statistics are global too
(``ops/fused_bn.py``). The parameters are broadcast from rank 0 when the
state is created.

Given a mesh (``parallel.build_mesh``, ``ctx.mesh``), the batch is split
over its data axes (``dp`` × ``fsdp``), whose group carries the gradient,
metric and BatchNorm reductions. With ``fsdp=True`` the parameters and the
optimizer state are sharded along ``fsdp`` (ZeRO-3, the JAX package's
per-array rule): the step body reduce-scatters each sharded gradient, the
optimizer updates this rank's shards, and an all-gather writes them back
into the module's full parameters, which stay resident
(``parallel.sharding.ShardedParams``). The same body runs eagerly and
inside the captured CUDA graph.

With the model's placement rules (``tp=`` / ``param_spec_fn=``, e.g.
``models.transformer.param_specs``) the model axes ``tp`` and ``ep`` split
parameters too: the module is built on the mesh
(``transformer.create_model(mesh=...)``) from this rank's blocks, and its
layers join them with gradient-carrying collectives in the forward and
backward, so the gradient all-reduce stays on the data axes. Under
``fsdp`` the ZeRO-3 overlay shards those blocks further. A checkpoint
still holds full tensors (``parallel.sharding.ModelShards``).

On a mesh with an ``sp`` axis (sequence parallelism: the model built on
the mesh runs ring attention over it, each rank on its block of the
sequence of the same rows) every rank's gradient is its tokens' share of
the loss's: the gradients are *summed* over ``sp`` and averaged over the
data axes, in one all-reduce over both (under ``fsdp`` a sum over ``sp``
comes first). The loss and the metrics are equal on the ranks of an ``sp``
group (``transformer.make_loss_fn``) and are averaged over the data axes
alone.

The step contract is the JAX version's (``mutable`` / ``has_aux`` /
``step=``), with the ``nn.Module`` in the place of the params pytree: the
module holds the parameters, and the step updates parameters, optimizer
state and BN running statistics in place (PyTorch's eager form of the JAX
version's donated state).

``compile_train_loop`` runs K steps a call, as the JAX version's
``lax.scan`` does in one XLA program. On a CUDA device its counterpart is a
train step captured once in a CUDA graph and replayed: one launch a step
in place of the ~2,000 the eager step issues from the host. On the CPU the
loop runs the eager step K times. :class:`PackedLoopCache` keeps one loop
a window size for the adaptive feed, all replaying one captured step.

:class:`BucketedOverlap` is the other gradient-sync path: a step of
microbatches whose gradients a comm thread reduces bucket by bucket over
the host (``parallel.hostreduce``) while the card runs the next
microbatch's backward.
"""

import inspect
import logging
import threading
import time

import torch
from torch.autograd.profiler import record_function

from tensorflowonspark_tpu_torch import util

logger = logging.getLogger(__name__)


class TrainState:
    """``step`` (int), ``module`` (the model, holding the full parameters
    and the BN running buffers), ``opt_state`` (the optimizer's), and
    ``model_state``: the module's buffers by name (the JAX version's
    ``batch_stats``), the same tensors the module uses. ``sharded`` is the
    ZeRO-3 state (:class:`~tensorflowonspark_tpu_torch.parallel.sharding.
    ShardedParams`) under ``fsdp=True``, whose shards the optimizer state
    mirrors; None when every rank holds everything. ``blocks`` (a
    :class:`~tensorflowonspark_tpu_torch.parallel.sharding.ModelShards`)
    describes the module's blocks of the parameters split over model axes
    (``tp``, ``ep``); None when the module is whole."""

    def __init__(self, step, module, opt_state, sharded=None, blocks=None):
        self.step = step
        self.module = module
        self.opt_state = opt_state
        self.sharded = sharded
        self.blocks = blocks

    @property
    def params(self):
        return dict(self.module.named_parameters())

    @property
    def model_state(self):
        return dict(self.module.named_buffers())


def _wants_step(loss_fn):
    try:
        return "step" in inspect.signature(loss_fn).parameters
    except (TypeError, ValueError):
        return False


class SyncDataParallel:
    """Synchronous data parallelism, optionally fully sharded.

    Usage inside ``main_fun(args, ctx)``::

        ctx.initialize_distributed()
        strategy = SyncDataParallel(ctx.device)       # a replica a process
        # or: SyncDataParallel(ctx.mesh({"dp": 1, "fsdp": -1}), fsdp=True)
        state = strategy.create_state(lambda: resnet50(...), optimizer)
        step = strategy.compile_train_step(loss_fn, optimizer, mutable=True)
        for batch in batches:
            state, metrics = step(state, strategy.shard_batch(batch))
    """

    def __init__(self, mesh=None, fsdp=False, min_weight_size=2**14, param_spec_fn=None, tp=False):
        """``mesh``: a :class:`~torch.distributed.device_mesh.DeviceMesh`
        (its device is this process's on it, and its data axes' group
        carries the reductions), or the device of this process's replica:
        ``None`` takes the card (:func:`util.select_device`, which raises
        without CUDA), as the JAX version's default mesh takes the
        accelerator; pass ``"cpu"`` to train on the CPU.

        ``fsdp=True`` shards along the mesh's ``fsdp`` axis every parameter
        of at least ``min_weight_size`` elements that has a dimension the
        axis divides (the largest such dimension of its flax layout, as the
        JAX package picks), and the optimizer state with it.
        ``param_spec_fn(module, mesh) -> {name: spec}`` supplies a model's
        own placement, which the ZeRO-3 overlay completes under ``fsdp``;
        its model axes (``tp``, ``ep``) split the module, which must be
        built on this mesh, and its ``fsdp`` entries shard only under
        ``fsdp=True`` (otherwise the data axes replicate).

        ``tp`` turns on tensor parallelism over the mesh's ``tp`` axis:
        pass the model's placement rules directly
        (``tp=transformer.param_specs``) or ``tp=True`` alongside an
        explicit ``param_spec_fn``. Only the model knows which dims are
        column- vs row-parallel, so ``tp`` without rules is an error, as is
        a mesh without a ``tp`` axis. ``fsdp`` composes: the model's tp
        specs place first, the ZeRO-3 overlay shards the rest."""
        from torch.distributed.device_mesh import DeviceMesh

        from tensorflowonspark_tpu_torch.parallel import collectives, mesh as mesh_lib, sharding

        if callable(tp):
            if param_spec_fn is not None and param_spec_fn is not tp:
                raise ValueError(
                    "pass the placement rules once: tp=<spec_fn> or "
                    "param_spec_fn=<spec_fn>, not two different functions"
                )
            param_spec_fn, tp = tp, True
        self.tp = bool(tp)
        self.fsdp, self.min_weight_size, self.param_spec_fn = fsdp, min_weight_size, param_spec_fn
        if isinstance(mesh, DeviceMesh):
            if fsdp and "fsdp" not in mesh.mesh_dim_names:
                raise ValueError("fsdp=True requires a mesh with an 'fsdp' axis; got {}".format(
                    mesh.mesh_dim_names))
            if self.tp and "tp" not in mesh.mesh_dim_names:
                raise ValueError("tp=... requires a mesh with a 'tp' axis; got {}".format(
                    mesh.mesh_dim_names))
            if self.tp and param_spec_fn is None:
                raise ValueError(
                    "tp=True needs the model's placement rules: pass "
                    "tp=<param_spec_fn> (e.g. models.transformer.param_specs) "
                    "or param_spec_fn= explicitly"
                )
            self.mesh, self.device = mesh, mesh_lib.mesh_device(mesh)
            self.data_group = sharding.data_group(mesh)
            #: the group of the data axes and sp, when the sequence is split
            #: over more than one sp rank (None otherwise)
            self.sequence_group = (collectives.axes_group(mesh, sharding.data_axes(mesh) + ("sp",))
                                   if sharding.mesh_axis_size(mesh, "sp") > 1 else None)
        else:
            if self.tp:
                raise ValueError("tp=... requires a mesh with a 'tp' axis; got the device {!r}".format(mesh))
            if fsdp or param_spec_fn is not None:
                raise ValueError("fsdp and param_spec_fn need a mesh, got the device {!r}".format(mesh))
            self.mesh, self.data_group, self.sequence_group = None, None, None
            self.device = torch.device(mesh) if mesh is not None else util.select_device("gpu")
        collectives.set_data_group(self.data_group)

    def param_shardings(self, module):
        """``{name: Sharding}`` of a module's parameters on the mesh (each
        spec of the whole tensor): the model's own rules
        (``param_spec_fn``) completed by the ZeRO-3 overlay under ``fsdp``
        (without it, their ``fsdp`` entries dropped), the ZeRO-3 rule
        alone, or replicated. Under ``fsdp`` the ``fsdp_params_sharded``
        gauge reports how many parameters ended up sharded, so a mis-sized
        ``min_weight_size`` (everything replicated) is visible in
        ``TFCluster.metrics()``; under ``tp`` the ``tp_params_sharded``
        gauge how many carry a ``tp`` dim."""
        from tensorflowonspark_tpu_torch import obs
        from tensorflowonspark_tpu_torch.parallel import sharding

        if self.param_spec_fn is not None:
            specs = self.param_spec_fn(module, self.mesh)
            if self.fsdp:
                specs = sharding.overlay_fsdp_specs(module, specs, self.mesh, self.min_weight_size)
            else:
                specs = {n: sharding.model_spec(s) for n, s in specs.items()}
        elif self.fsdp:
            specs = sharding.fsdp_param_specs(module, self.mesh, self.min_weight_size)
        else:
            specs = {n: () for n, _ in module.named_parameters()}
        if self.fsdp:
            obs.gauge(
                "fsdp_params_sharded", help="param arrays sharded along the fsdp axis (ZeRO-3)",
            ).set(sum(1 for s in specs.values() if "fsdp" in sharding._spec_axes(s)))
        if self.tp:
            obs.gauge(
                "tp_params_sharded", help="param arrays sharded along the tp axis (tensor parallelism)",
            ).set(sum(1 for s in specs.values() if "tp" in sharding._spec_axes(s)))
        return {n: sharding.Sharding(self.mesh, s) for n, s in specs.items()}

    def shard_batch(self, batch):
        """Place this process's batch (numpy arrays or tensors) on the device."""
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}

    def create_state(self, init_fn, optimizer, *init_args):
        """``init_fn(*init_args)`` builds the module; it moves to the device,
        its parameters and buffers are broadcast from rank 0 (so replicas
        start equal; the blocks of a module built on the mesh from the
        first of the ranks that hold the same block), and the optimizer
        state is created for it — under ``fsdp``, for this rank's shards of
        the sharded parameters. A module whose blocks are not the ones the
        placement rules give on this mesh raises."""
        from tensorflowonspark_tpu_torch.parallel import sharding

        module = init_fn(*init_args).to(self.device)
        specs = ({n: s.spec for n, s in self.param_shardings(module).items()}
                 if self.mesh is not None else {})
        held = getattr(module, "model_specs", {})
        placed = {n: sharding.model_spec(s) for n, s in specs.items() if any(sharding.model_spec(s))}
        if held != placed:
            raise ValueError(
                "the module holds blocks {} where this strategy's placement gives {}: build it "
                "on the strategy's mesh (create_model(mesh=...)) and pass its placement rules "
                "(tp= / param_spec_fn=)".format(held, placed))
        blocks = sharding.ModelShards(module, self.mesh, specs) if placed else None
        if util.world_size() > 1:
            import torch.distributed as dist

            with torch.no_grad():
                if blocks is not None:
                    blocks.broadcast(module)
                else:
                    for t in list(module.parameters()) + list(module.buffers()):
                        dist.broadcast(t, src=0)
        if not self.fsdp:
            return TrainState(0, module, optimizer.init(dict(module.named_parameters())), blocks=blocks)
        sharded = sharding.ShardedParams(module, self.mesh, {n: sharding.data_spec(s) for n, s in specs.items()})
        return TrainState(0, module, optimizer.init(sharded.optimizer_params(module)), sharded, blocks)

    def compile_train_step(self, loss_fn, optimizer, has_aux=False, mutable=False, donate=True):
        """``step(state, batch) -> (state, metrics)``.

        * ``mutable=False``: ``loss_fn(module, batch) -> loss`` or
          ``(loss, aux_metrics)`` with ``has_aux=True``.
        * ``mutable=True`` (models with BN statistics):
          ``loss_fn(module, model_state, batch) -> (loss, (new_model_state,
          aux_metrics))`` — ``has_aux`` is implied.

        A ``loss_fn`` that declares a ``step`` keyword receives
        ``state.step``. Nothing is compiled: PyTorch runs eagerly, and the
        name keeps the JAX version's API. ``metrics`` hold device tensors;
        reading one waits for the step. With more than one rank, ``loss``
        and the aux metrics are their means over the ranks (the global
        batch's, when each rank's loss averages as many terms). The step's
        phases are profiler ranges (``train_step.forward``, ``.backward``,
        ``.optimizer``).

        ``donate`` (``True``, ``False``, ``"state"`` or ``"batches"``; any
        other value raises ``ValueError``) is accepted for the JAX version's
        signature, as :meth:`compile_train_loop` accepts it: the state is
        updated in place whatever its value, and the batch is never
        consumed.
        """
        _check_donate(donate)
        body = _train_body(loss_fn, optimizer, has_aux, mutable, self._reduce())
        wants_step = _wants_step(loss_fn)

        def train_step(state, batch):
            metrics = body(state, batch, {"step": state.step} if wants_step else {})
            state.step += 1
            return state, _with_step(metrics, state.step)

        return train_step

    def compile_train_loop(self, loss_fn, optimizer, num_steps, has_aux=False, mutable=False,
                           donate=True, packed=False):
        """``loop(state, batches) -> (state, metrics of the last step)``,
        running ``num_steps`` train steps a call; ``state.step`` advances by
        ``num_steps``. The loss contract is :meth:`compile_train_step`'s.

        ``batches`` is a list of ``num_steps`` device batches
        (:func:`~tensorflowonspark_tpu_torch.data.loop_prefetch` places them
        ahead), or with ``packed=True`` one batch whose tensors carry a
        leading ``num_steps`` axis
        (:func:`~tensorflowonspark_tpu_torch.data.packed_prefetch`); any
        other count raises ``ValueError``, as in the JAX version.

        On a CUDA device the first steps run eagerly on a side stream (the
        warm-up: the kernels' builds, the BN workspace at its largest,
        cuBLAS and NCCL set-up), then one step is captured in a CUDA graph
        and every later step copies its batch into the graph's static input
        buffers and replays it. Warm-up steps are real steps of the first
        window. A ``loss_fn`` that declares ``step`` receives it as a device
        tensor, which the graph advances. With more than one rank the NCCL
        all-reduces (gradients and metrics, BN statistics) are inside the
        graph. A capture that fails raises; the loop never falls back to
        eager steps on the card. On the CPU it runs the eager step
        ``num_steps`` times.

        ``donate`` is accepted for the JAX version's signature: the state is
        updated in place in every mode, and batches are never consumed.
        """
        if int(num_steps) < 1:
            raise ValueError("num_steps must be at least 1, got {}".format(num_steps))
        _check_donate(donate)
        if self.device.type == "cuda":
            return _CapturedLoop(_train_body(loss_fn, optimizer, has_aux, mutable, self._reduce()),
                                 _wants_step(loss_fn), int(num_steps), packed, self.device)
        step = self.compile_train_step(loss_fn, optimizer, has_aux=has_aux, mutable=mutable)

        def loop(state, batches):
            metrics = None
            for batch in _window(batches, num_steps, packed):
                state, metrics = step(state, batch)
            return state, metrics

        return loop

    def _reduce(self):
        """The step's reduction over the data axes: None (one rank, no
        mesh), or ``reduce(state, grads, metrics) -> (grads, metrics)``."""
        import torch.distributed as dist

        from tensorflowonspark_tpu_torch.parallel.sharding import _all_reduce_sum

        if self.fsdp:
            return lambda state, grads, metrics: state.sharded.reduce_grads(grads, metrics)
        group, sequence = self.data_group, self.sequence_group
        size = util.world_size() if self.mesh is None else dist.get_world_size(group)
        if size == 1 and sequence is None:
            return None

        def reduce(state, grads, metrics):
            tensors = list(grads.values())
            if sequence is None:
                metrics = _all_reduce_sum(tensors, metrics, group)
            else:  # summed over sp as well; the metrics are equal there already
                _all_reduce_sum(tensors, {}, sequence)
                if size > 1:
                    metrics = _all_reduce_sum([], metrics, group)
            if size > 1:
                for g in tensors:
                    g /= size
                metrics = {k: v / size for k, v in metrics.items()}
            return grads, metrics

        return reduce

    def compile_eval_step(self, metric_fn):
        """``eval_step(module_or_state, *args)``: ``metric_fn(module,
        *args)`` with the module in eval mode (running BN statistics) under
        ``torch.no_grad``; the module's mode is restored after."""
        return _inference(metric_fn)

    def compile_predict_step(self, apply_fn):
        """``predict_step(module_or_state, *args)``: ``apply_fn(module,
        *args)`` as :meth:`compile_eval_step` runs it; the predictions stay
        on this process's device."""
        return _inference(apply_fn)


def _check_donate(donate):
    """The JAX version's values of ``donate`` (it donates the state's
    buffers, the batches' or both to XLA); anything else raises."""
    if donate not in (True, False, "state", "batches"):
        raise ValueError("donate must be True, False, 'state' or 'batches', got {!r}".format(donate))


def _inference(fn):
    def run(module, *args, **kwargs):
        module = getattr(module, "module", module)  # a TrainState or the module
        was_training = module.training
        module.eval()
        try:
            with torch.no_grad():
                return fn(module, *args, **kwargs)
        finally:
            module.train(was_training)

    return run


def _train_body(loss_fn, optimizer, has_aux, mutable, reduce):
    """One train step's work, with no host sync: ``body(state, batch, kw) ->
    metrics`` (``loss`` and the aux metrics, averaged over the data axes),
    the parameters, optimizer state and BN statistics updated in place.
    ``kw`` goes to ``loss_fn`` (``{"step": ...}`` or empty); ``reduce`` is
    the strategy's reduction (None: one rank). The gradients are set to
    None first, so the backward writes fresh ones; under CUDA graph capture
    those come from the graph's pool, static buffers that every replay
    writes in full. A sharded state's optimizer updates its shards, which
    are then gathered back into the module."""

    def body(state, batch, kw):
        module = state.module
        module.train()
        for p in module.parameters():
            p.grad = None
        with record_function("train_step.forward"):
            if mutable:
                loss, (model_state, aux) = loss_fn(module, state.model_state, batch, **kw)
                _adopt_model_state(module, model_state)
            else:
                out = loss_fn(module, batch, **kw)
                loss, aux = out if has_aux else (out, None)
        with record_function("train_step.backward"):
            loss.backward()
        with record_function("train_step.optimizer"):
            grads = {n: p.grad for n, p in module.named_parameters()}
            metrics = {"loss": loss.detach()}
            if aux:
                metrics.update(aux)
            if reduce is not None:
                grads, metrics = reduce(state, grads, metrics)
            if state.sharded is None:
                optimizer.update(dict(module.named_parameters()), grads, state.opt_state)
            else:
                optimizer.update(state.sharded.optimizer_params(module), grads, state.opt_state)
                state.sharded.gather()
        return metrics

    return body


def _with_step(metrics, step):
    """The JAX version's metrics layout: ``loss``, ``step``, then aux."""
    out = {"loss": metrics["loss"], "step": step}
    out.update((k, v) for k, v in metrics.items() if k != "loss")
    return out


def _window(batches, num_steps, packed):
    """The ``num_steps`` per-step batches of one loop call, with the JAX
    version's errors for a wrong count or leading dimension."""
    if packed:
        lead = {v.shape[0] for v in batches.values()}
        if lead != {num_steps}:
            raise ValueError("packed window has leading dims {}, loop compiled for {}".format(
                sorted(lead), num_steps))
        return [{k: v[i] for k, v in batches.items()} for i in range(num_steps)]
    if len(batches) != num_steps:
        raise ValueError("got {} batches, loop compiled for {}".format(len(batches), num_steps))
    return list(batches)


class _CapturedLoop:
    """``compile_train_loop`` on a CUDA device: warm-up steps on a side
    stream, then one step captured in a CUDA graph and replayed.

    The graph holds the addresses of everything the step touches: the
    module's parameters and buffers and the optimizer's state (all updated
    in place), the static input buffers each batch is copied into, the
    gradients and every temporary (the graph's private pool) and the BN
    reductions' workspace of the side stream (grown to its largest during
    the warm-up). A kernel wrapper's Python body does not run on replay:
    its ``launches`` count the warm-up steps' launches and the capture's,
    and the replays' kernels are read from a profiler trace
    (``ops/kernel_trace.py``).

    The captured step is apart from the window size: :meth:`with_steps`
    gives a loop of another size over the same step (its warm-up count,
    graph and pool), as :class:`PackedLoopCache` builds one a bucket.
    """

    #: eager steps before the capture: the first builds the kernels and
    #: sets up cuBLAS, NCCL and the workspaces; the second runs them warm
    WARMUP = 2

    def __init__(self, body, wants_step, num_steps, packed, device, step=None):
        self.num_steps, self.packed = num_steps, packed
        self.step = step if step is not None else _CapturedStep(body, wants_step, device)

    def with_steps(self, num_steps):
        """A loop of ``num_steps`` steps a call that replays this loop's
        captured step."""
        return _CapturedLoop(None, None, int(num_steps), self.packed, None, self.step)

    def __call__(self, state, batches):
        return self.step.run(state, _window(batches, self.num_steps, self.packed))


class _CapturedStep:
    """The warm-up steps, the capture and the replays of one train step
    (see :class:`_CapturedLoop`)."""

    def __init__(self, body, wants_step, device):
        self.body, self.wants_step, self.device = body, wants_step, device
        self.module = None

    def _reset(self, state):
        self.module = state.module
        self.stream = torch.cuda.Stream(self.device)
        self.warm = 0
        self.graph = self.static = self.out = None
        self.step_t = torch.zeros((), dtype=torch.int64, device=self.device) if self.wants_step else None

    def _kw(self):
        return {"step": self.step_t} if self.wants_step else {}

    def _eager(self, state, batch):
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            metrics = self.body(state, batch, self._kw())
            if self.step_t is not None:
                self.step_t += 1
        current.wait_stream(self.stream)
        self.warm += 1
        return metrics

    def _capture(self, state, batch):
        self.static = {k: torch.empty_like(v) for k, v in batch.items()}
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        graph = torch.cuda.CUDAGraph()
        # thread_local: other threads of the trainer (the input pipeline,
        # the obs plane) may call CUDA while this one captures
        with torch.cuda.graph(graph, stream=self.stream, capture_error_mode="thread_local"):
            out = self.body(state, self.static, self._kw())
            if self.step_t is not None:
                self.step_t += 1
        self.graph, self.out = graph, out

    def _replay(self, batch):
        if batch.keys() != self.static.keys() or any(
                v.shape != self.static[k].shape or v.dtype != self.static[k].dtype
                for k, v in batch.items()):
            raise ValueError("batch {} differs from the captured step's {}".format(
                {k: (tuple(v.shape), v.dtype) for k, v in batch.items()},
                {k: (tuple(v.shape), v.dtype) for k, v in self.static.items()}))
        for k, v in batch.items():
            self.static[k].copy_(v, non_blocking=True)
        self.graph.replay()

    def run(self, state, window):
        if state.module is not self.module:
            self._reset(state)
        if self.step_t is not None:
            self.step_t.fill_(state.step)
        metrics = None
        for batch in window:
            if self.warm < _CapturedLoop.WARMUP:
                metrics = self._eager(state, batch)
            else:
                if self.graph is None:
                    self._capture(state, batch)
                self._replay(batch)
                metrics = self.out
            state.step += 1
        # the graph's outputs are rewritten by the next replay
        metrics = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}
        return state, _with_step(metrics, state.step)


def _adopt_model_state(module, model_state):
    """Copy a loss function's returned model state into the module's
    buffers (a no-op for the usual in-place update of those buffers)."""
    buffers = dict(module.named_buffers())
    with torch.no_grad():
        for name, value in model_state.items():
            if value is not buffers[name]:
                buffers[name].copy_(value)


class BucketedOverlap:
    """Bucketed gradient sync overlapping the host all-reduce with backprop.

    The step splits into microbatches, and gradient synchronization moves
    onto a dedicated comm thread: as each microbatch's backward is queued,
    the comm thread waits for it (a CUDA event recorded after that backward,
    not a device sync, so the card runs the next microbatch meanwhile),
    copies its gradients bucket by bucket into pinned host buffers on a copy
    stream, and runs one deterministic host all-reduce a bucket through a
    :class:`~tensorflowonspark_tpu_torch.parallel.hostreduce.HostAllReduceGroup`.
    Buckets are byte-bounded and hold one dtype each. The host accumulates
    the reduced buckets in microbatch order, and the optimizer applies their
    mean once a step. On the CPU the gradients are ready when their
    ``autograd.grad`` returns and are copied as they are.

    ``overlap=False`` runs the *identical* work in the same order but joins
    the comm thread after every microbatch — the same gradients, copies,
    sums and reductions, differing only in host-side fencing, so loss
    trajectories are bitwise equal with overlap on or off.

    Each microbatch's gradients are fresh tensors (``torch.autograd.grad``,
    never ``.grad`` accumulated in place): the comm thread may still be
    copying microbatch i's while microbatch i + 1's backward runs. The
    optimizer updates the parameters in place only after :meth:`step` has
    drained the comm thread, so no copy in flight reads them.

    Scope: data parallelism over parameters that are replicated across the
    processes of the host group — pure dp (each process steps its own
    replica, like the reference's ``MultiWorkerMirroredStrategy``) and dp×tp
    (the module holds this rank's tp blocks; the group is then the ``dp``
    ranks of this rank's tp position, one group a position, e.g.
    ``HostAllReduceGroup(dp_index, dp_size, process_group=mesh.get_group(
    "dp"))``, and each rank's blocks stay its blocks). FSDP is NOT
    supported: each process holds only a partition of its replica, so a
    host all-reduce of its shards would not be a replica's gradient; the
    constructor rejects that composition by axis name.

    ``loss_fn(module, batch) -> loss`` (or ``(loss, aux)`` with
    ``has_aux``; the aux metrics are dropped, as in the JAX version). Per
    step stats land in :attr:`last_stats` and the ``comm_overlap_fraction``
    gauge::

        group = HostAllReduceGroup(rank, world)
        sched = BucketedOverlap(strategy, loss_fn, optimizer, group=group)
        state, metrics = sched.step(state, microbatches)
    """

    def __init__(self, strategy, loss_fn, optimizer, group=None,
                 bucket_bytes=1 << 22, overlap=True, has_aux=False):
        import queue

        if getattr(strategy, "fsdp", False):
            raise ValueError(
                "BucketedOverlap cannot sync params sharded along mesh "
                "axes ('fsdp',): each process holds only a partition of "
                "its replica, and FSDP params already sync through the "
                "strategy's reduce-scatter/all-gather. Supported "
                "compositions: replicated params (pure dp) and tp-sharded "
                "params (dp x tp) — only the replicated dp axis is "
                "all-reduced host-side."
            )
        self.strategy = strategy
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.group = group
        self.bucket_bytes = int(bucket_bytes)
        self.overlap = overlap
        self.has_aux = has_aux
        self.last_stats = {}
        self._buckets = None  # list of (dtype, [grad indices]) once shapes known
        self._pinned = None  # one pinned host buffer a bucket (CUDA)
        self._copy_stream = None
        # bounded: a stalled all-reduce worker should backpressure the
        # dispatch loop, not let gradient buckets pile up unboundedly
        self._jobs = queue.Queue(maxsize=32)
        self._worker = None
        self._worker_err = None

    # -- bucket partition ------------------------------------------------------

    def _partition(self, grads):
        """Partition flat gradient indices into byte-bounded buckets, one
        dtype per bucket (payloads concatenate raw)."""
        buckets = []
        cur, cur_bytes, cur_dtype = [], 0, None
        order = sorted(range(len(grads)), key=lambda i: str(grads[i].dtype))
        for i in order:
            g = grads[i]
            dt, nbytes = str(g.dtype), g.numel() * g.element_size()
            if cur and (dt != cur_dtype or cur_bytes + nbytes > self.bucket_bytes):
                buckets.append((cur_dtype, cur))
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nbytes
            cur_dtype = dt
        if cur:
            buckets.append((cur_dtype, cur))
        return buckets

    # -- comm thread -----------------------------------------------------------

    def _fetch(self, b, leaves, ready):
        """Bucket ``b``'s gradients as one flat host numpy array: on the
        card copied into the bucket's pinned buffer on the copy stream (the
        array is a view of it, valid until the bucket's next fetch), on the
        CPU concatenated."""
        if ready is None:
            return torch.cat([g.reshape(-1) for g in leaves]).numpy()
        pinned = self._pinned[b]
        if pinned is None:
            pinned = self._pinned[b] = torch.empty(sum(g.numel() for g in leaves), dtype=leaves[0].dtype,
                                                   pin_memory=True)
        self._copy_stream.wait_event(ready)
        with torch.cuda.stream(self._copy_stream):
            off = 0
            for g in leaves:
                pinned[off:off + g.numel()].copy_(g.reshape(-1), non_blocking=True)
                off += g.numel()
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        copied.synchronize()
        return pinned.numpy()

    def _comm_loop(self):
        while True:
            job = self._jobs.get()
            if job is None:
                return
            grads, ready, acc, done, stats, record = job
            try:
                for b, (_dtype, idxs) in enumerate(self._buckets):
                    t0 = time.perf_counter()
                    if ready is not None:
                        ready.synchronize()  # this microbatch's backward, not the device
                    t1 = time.perf_counter()
                    stats["device_wait_s"] += t1 - t0
                    record["dw_end"] = t1
                    flat = self._fetch(b, [grads[i] for i in idxs], ready)
                    if self.group is not None:
                        flat = self.group.allreduce_mean(flat)
                    off = 0
                    for i in idxs:
                        n = grads[i].numel()
                        part = flat[off:off + n].reshape(tuple(grads[i].shape))
                        acc[i] = part.copy() if acc[i] is None else acc[i] + part
                        off += n
                    t2 = time.perf_counter()
                    record["comm_spans"].append((t1, t2))
                    stats["comm_busy_s"] += t2 - t1
            except BaseException as e:  # surfaces at the next drain
                self._worker_err = e
            finally:
                job = grads = None  # the microbatch's gradients are free once copied
                done.set()

    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._comm_loop, name="grad-comm", daemon=True
            )
            self._worker.start()

    def _check_err(self):
        if self._worker_err is not None:
            err, self._worker_err = self._worker_err, None
            raise RuntimeError("gradient comm thread failed") from err

    # -- the step --------------------------------------------------------------

    def step(self, state, microbatches):
        """One optimizer step over ``microbatches`` (a non-empty list of
        batches, each already on the device via ``strategy.shard_batch``).
        Returns ``(state, metrics)`` with the loss averaged over
        microbatches and ranks."""
        if not microbatches:
            raise ValueError("step needs at least one microbatch")
        self._ensure_worker()
        self._check_err()
        module = state.module
        module.train()
        names, params = zip(*[(n, p) for n, p in module.named_parameters() if p.requires_grad])
        cuda = params[0].device.type == "cuda"
        stats = {"comm_busy_s": 0.0, "device_wait_s": 0.0, "blocked_s": 0.0}
        losses, dones, records = [], [], []
        acc = [None] * len(params)
        t_step0 = time.perf_counter()
        for batch in microbatches:
            dispatch_ts = time.perf_counter()
            out = self.loss_fn(module, batch)
            loss = out[0] if self.has_aux else out
            # fresh gradient tensors a microbatch: the comm thread reads them
            # while the next microbatch's backward runs
            grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
            ready = None
            if cuda:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(params[0].device))
            if self._buckets is None:
                self._buckets = self._partition(grads)
                self._pinned = [None] * len(self._buckets)
                if cuda:
                    self._copy_stream = torch.cuda.Stream(params[0].device)
                logger.info(
                    "bucketed overlap: %d grad arrays -> %d bucket(s) <= %d bytes",
                    len(grads), len(self._buckets), self.bucket_bytes,
                )
            losses.append(loss.detach())
            done = threading.Event()
            dones.append(done)
            record = {"dispatch_ts": dispatch_ts, "comm_spans": [], "dw_end": 0.0}
            records.append(record)
            self._jobs.put((grads, ready, acc, done, stats, record))
            del grads
            if not self.overlap:
                t0 = time.perf_counter()
                done.wait()
                stats["blocked_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        for done in dones:
            done.wait()
        stats["blocked_s"] += time.perf_counter() - t0
        self._check_err()

        scale = 1.0 / len(microbatches)
        device = params[0].device
        grads = {n: torch.from_numpy(a).to(device) * scale for n, a in zip(names, acc)}
        self.optimizer.update(dict(zip(names, params)), grads, state.opt_state)
        state.step += 1
        loss = torch.stack(losses).mean()
        if self.group is not None and self.group.world > 1:
            loss_mean = torch.from_numpy(self.group.allreduce_mean(
                loss.float().cpu().numpy().reshape(1)))[0]
        else:
            loss_mean = loss
        stats["step_s"] = time.perf_counter() - t_step0
        # measured overlap: comm seconds that ran while backprop work from a
        # later microbatch was queued on the card. Job i's comm is hidden
        # where its spans fall inside [dispatch of job i+1, last grad-ready
        # time]; before that window nothing later is queued, after it the
        # device is idle. overlap=False joins the comm thread before
        # dispatching the next microbatch, so the window is empty and the
        # fraction is exactly 0 — same work, same order, only fencing.
        window_end = max((r["dw_end"] for r in records), default=0.0)
        hidden = 0.0
        for i, rec in enumerate(records):
            if i + 1 >= len(records):
                break  # last job's comm has nothing behind it to hide under
            window_start = records[i + 1]["dispatch_ts"]
            for s, e in rec["comm_spans"]:
                hidden += max(0.0, min(e, window_end) - max(s, window_start))
        stats["hidden_comm_s"] = hidden
        stats["overlap_fraction"] = (
            min(1.0, hidden / stats["comm_busy_s"])
            if stats["comm_busy_s"] > 0
            else 0.0
        )
        stats["buckets"] = len(self._buckets)
        self.last_stats = stats
        from tensorflowonspark_tpu_torch import obs
        from tensorflowonspark_tpu_torch.obs import tracing as obs_tracing

        obs.gauge(
            "comm_overlap_fraction",
            help="fraction of host all-reduce time hidden behind device backprop",
        ).set(stats["overlap_fraction"])
        if obs_tracing.active():
            # publish the comm thread's measured intervals as retroactive
            # spans on the dedicated comm track: perf_counter -> wall via a
            # single anchor, comm_window marking where later backprop could
            # hide each bucket — tracemerge recomputes the overlap fraction
            # from exactly these drawn spans to corroborate the gauge
            anchor = time.time() - time.perf_counter()
            for i, rec in enumerate(records):
                for s, e in rec["comm_spans"]:
                    obs_tracing.record_span(
                        "comm_allreduce", ts=anchor + s, dur_s=e - s,
                        track="comm", microbatch=i,
                    )
                if i + 1 < len(records) and window_end > records[i + 1]["dispatch_ts"]:
                    win0 = records[i + 1]["dispatch_ts"]
                    obs_tracing.record_span(
                        "comm_window", ts=anchor + win0, dur_s=window_end - win0,
                        track="comm_window", microbatch=i,
                    )
        metrics = {"loss": loss_mean, "step": state.step}
        return state, metrics

    def close(self):
        """Stop the comm thread (the group is the caller's to close)."""
        if self._worker is not None and self._worker.is_alive():
            self._jobs.put(None)
            self._worker.join(timeout=10)
        self._worker = None


class PackedLoopCache:
    """Per-K cache of packed train loops for the adaptive feed.

    The :class:`~tensorflowonspark_tpu_torch.data.autotune.FeedAutotuner`
    varies the packed-window size K at runtime, but
    :meth:`SyncDataParallel.compile_train_loop` builds a loop for a static
    ``num_steps`` — so each bucket gets its own loop, built on first use and
    reused forever after. Every build increments the
    ``feed_recompiles_total`` counter, so the trade shows up in
    ``TFCluster.metrics()``.

    On the card every bucket's loop replays ONE captured train step
    (:meth:`_CapturedLoop.with_steps`): one warm-up, one CUDA graph and one
    private pool for the whole cache, since the windows run one after
    another, so more buckets take no more device memory than one. On the
    CPU each bucket's loop runs the eager step K times::

        cache = PackedLoopCache(strategy, loss_fn, optimizer, mutable=True)
        for window in autotuned_prefetch(pipe, strategy, tuner=tuner):
            state, metrics = cache.run(state, window)
    """

    def __init__(self, strategy, loss_fn, optimizer, has_aux=False, mutable=False):
        self.strategy = strategy
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.has_aux = has_aux
        self.mutable = mutable
        self._loops = {}

    def loop_for(self, num_steps):
        """The packed loop for window size ``num_steps``."""
        compiled = self._loops.get(num_steps)
        if compiled is None:
            from tensorflowonspark_tpu_torch import obs

            obs.counter(
                "feed_recompiles_total",
                help="packed train-loop compilations (bounded by the bucket set)",
            ).inc()
            logger.info("building packed train loop for window K=%d", num_steps)
            shared = next(iter(self._loops.values()), None)
            if isinstance(shared, _CapturedLoop):
                compiled = shared.with_steps(num_steps)
            else:
                compiled = self.strategy.compile_train_loop(
                    self.loss_fn, self.optimizer, num_steps,
                    has_aux=self.has_aux, mutable=self.mutable,
                    donate="state", packed=True,
                )
            self._loops[num_steps] = compiled
        return compiled

    def run(self, state, window):
        """Run one :class:`~tensorflowonspark_tpu_torch.data.autotune.AutotunedWindow`
        (or any object with ``.data``/``.k``) through its bucket's loop."""
        return self.loop_for(window.k)(state, window.data)

    @property
    def compiled_sizes(self):
        """The buckets built so far (sorted)."""
        return sorted(self._loops)


def run_steps(step_fn, state, batches, engine=None, save_every_n=None, hooks=()):
    """Drive a step (or loop) function over ``batches`` with per-step hooks
    and non-blocking checkpointing. Returns ``(state, last_metrics)``.

    Each step is two obs spans, ``step_fetch`` (the next batch) and
    ``step_compute`` (the step), with the global step as an attribute; each
    lands in the flight shard and in the ``{span}_seconds`` histogram.
    ``hooks`` are callables ``hook(state, global_step, metrics)`` run after
    every step (eval triggers, LR logging); the global step is counted on
    the host from one initial read of ``state.step`` and advances one per
    call of ``step_fn`` (a loop's call too, as in the JAX version).

    The loop hook for the async checkpoint engine
    (:class:`tensorflowonspark_tpu_torch.ckpt.AsyncCheckpointEngine`): every
    ``save_every_n`` steps (default: the engine's own cadence) the state is
    snapshotted to host in a ``ckpt_snapshot`` span — the only checkpoint
    cost the training thread pays — and committed in the background; on
    exit (including an exception unwinding through the loop) the engine is
    **drained** so the final snapshot lands before the caller tears
    anything down.

    Safe by ordering: the step updates the state in place, and on the card
    the snapshot's device-to-host copies are queued on the current stream,
    the one the next step (or replayed graph) runs on, so they read this
    step's state before the next step writes it; the writer waits for them
    before it reads the host buffers.
    """
    from tensorflowonspark_tpu_torch import obs

    start = state.get("step", 0) if isinstance(state, dict) else getattr(state, "step", 0)
    start_step = int(start)
    cadence = save_every_n if save_every_n is not None else (
        engine.save_every_n if engine is not None else 0
    )
    metrics = None
    it = iter(batches)
    i = 0
    try:
        while True:
            with obs.span("step_fetch", step=start_step + i + 1):
                try:
                    batch = next(it)
                except StopIteration:
                    break
            with obs.span("step_compute", step=start_step + i + 1):
                state, metrics = step_fn(state, batch)
            global_step = start_step + i + 1
            for hook in hooks:
                hook(state, global_step, metrics)
            if engine is not None and cadence and global_step % cadence == 0:
                with obs.span("ckpt_snapshot", step=global_step):
                    engine.save(state, global_step)
            i += 1
    finally:
        if engine is not None:
            engine.drain()
    return state, metrics


def steps_per_worker(total_examples, batch_size, num_workers, safety=0.9):
    """Per-worker step budget for InputMode.SPARK feeding.

    Spark partitions are uneven, so a worker that demands exactly
    ``total/batch/workers`` steps can starve at the epoch tail and hang the
    collective. The reference buried this as example folklore — "limit
    steps to ~90% of expected to account for uneven partitions" (its
    ``examples/mnist/keras/mnist_spark.py``); here it is the documented
    helper, copied from the JAX package.
    """
    per_worker = total_examples // (batch_size * max(num_workers, 1))
    return max(1, int(per_worker * safety))
