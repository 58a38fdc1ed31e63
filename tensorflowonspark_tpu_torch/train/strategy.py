"""Synchronous data parallelism over ``torch.distributed`` — the port of the
JAX package's ``train/strategy.py``.

There the strategy owns a device mesh and XLA derives the gradient
all-reduce from shardings. Here each process owns one device and a full
replica: batches are placed on ``ctx.device``, and with more than one
process the gradients, the loss and the aux metrics are averaged with one
all-reduce per step before the optimizer runs, so every replica takes the
same update, parameters stay bit-identical across ranks, and every rank
reports the global batch's loss. BatchNorm statistics are global too
(``ops/fused_bn.py``). The parameters are broadcast from rank 0 when the
state is created.

The step contract is the JAX version's (``mutable`` / ``has_aux`` /
``step=``), with the ``nn.Module`` in the place of the params pytree: the
module holds the parameters, and the step updates parameters, optimizer
state and BN running statistics in place (PyTorch's eager form of the JAX
version's donated state).

``compile_train_loop`` runs K steps a call, as the JAX version's
``lax.scan`` does in one XLA program. On a CUDA device its counterpart is a
train step captured once in a CUDA graph and replayed: one launch a step
in place of the ~2,000 the eager step issues from the host. On the CPU the
loop runs the eager step K times.
"""

import inspect
import logging

import torch
from torch.autograd.profiler import record_function

from tensorflowonspark_tpu_torch import util

logger = logging.getLogger(__name__)


class TrainState:
    """``step`` (int), ``module`` (the model, holding the parameters and
    the BN running buffers), ``opt_state`` (the optimizer's), and
    ``model_state``: the module's buffers by name (the JAX version's
    ``batch_stats``), the same tensors the module uses."""

    def __init__(self, step, module, opt_state):
        self.step = step
        self.module = module
        self.opt_state = opt_state

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
    """Synchronous data parallelism: one full replica per process.

    Usage inside ``main_fun(args, ctx)``::

        ctx.initialize_distributed()
        strategy = SyncDataParallel(ctx.device)
        state = strategy.create_state(lambda: resnet50(...), optimizer)
        step = strategy.compile_train_step(loss_fn, optimizer, mutable=True)
        for batch in batches:
            state, metrics = step(state, strategy.shard_batch(batch))
    """

    def __init__(self, device=None, fsdp=False, tp=False):
        """``device``: where this process's replica lives; ``None`` takes the
        card (:func:`util.select_device`, which raises without CUDA), as the
        JAX version's default mesh takes the accelerator. Pass ``"cpu"`` to
        train on the CPU."""
        if fsdp or tp:
            raise NotImplementedError(
                "fsdp/tp are not yet ported to tensorflowonspark_tpu_torch; "
                "SyncDataParallel replicates the model on every process"
            )
        self.device = torch.device(device) if device is not None else util.select_device("gpu")

    def shard_batch(self, batch):
        """Place this process's batch (numpy arrays or tensors) on the device."""
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}

    def create_state(self, init_fn, optimizer, *init_args):
        """``init_fn(*init_args)`` builds the module; it moves to the device,
        its parameters and buffers are broadcast from rank 0 (so replicas
        start equal), and the optimizer state is created for it."""
        module = init_fn(*init_args).to(self.device)
        if util.world_size() > 1:
            import torch.distributed as dist

            with torch.no_grad():
                for t in list(module.parameters()) + list(module.buffers()):
                    dist.broadcast(t, src=0)
        return TrainState(0, module, optimizer.init(dict(module.named_parameters())))

    def compile_train_step(self, loss_fn, optimizer, has_aux=False, mutable=False):
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
        """
        body = _train_body(loss_fn, optimizer, has_aux, mutable)
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
        if donate not in (True, False, "state", "batches"):
            raise ValueError("donate must be True, False, 'state' or 'batches', got {!r}".format(donate))
        if self.device.type == "cuda":
            return _CapturedLoop(_train_body(loss_fn, optimizer, has_aux, mutable),
                                 _wants_step(loss_fn), int(num_steps), packed, self.device)
        step = self.compile_train_step(loss_fn, optimizer, has_aux=has_aux, mutable=mutable)

        def loop(state, batches):
            metrics = None
            for batch in _window(batches, num_steps, packed):
                state, metrics = step(state, batch)
            return state, metrics

        return loop

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


def _train_body(loss_fn, optimizer, has_aux, mutable):
    """One train step's work, with no host sync: ``body(state, batch, kw) ->
    metrics`` (``loss`` and the aux metrics, averaged over the ranks), the
    parameters, optimizer state and BN statistics updated in place.
    ``kw`` goes to ``loss_fn`` (``{"step": ...}`` or empty). The gradients
    are set to None first, so the backward writes fresh ones; under CUDA
    graph capture those come from the graph's pool, static buffers that
    every replay writes in full."""

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
            params = dict(module.named_parameters())
            grads = {n: p.grad for n, p in params.items()}
            metrics = {"loss": loss.detach()}
            if aux:
                metrics.update(aux)
            if util.world_size() > 1:
                metrics = _all_reduce_mean(list(grads.values()), metrics)
            optimizer.update(params, grads, state.opt_state)
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
    """

    #: eager steps before the capture: the first builds the kernels and
    #: sets up cuBLAS, NCCL and the workspaces; the second runs them warm
    WARMUP = 2

    def __init__(self, body, wants_step, num_steps, packed, device):
        self.body, self.wants_step = body, wants_step
        self.num_steps, self.packed, self.device = num_steps, packed, device
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

    def __call__(self, state, batches):
        window = _window(batches, self.num_steps, self.packed)
        if state.module is not self.module:
            self._reset(state)
        if self.step_t is not None:
            self.step_t.fill_(state.step)
        metrics = None
        for batch in window:
            if self.warm < self.WARMUP:
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


def _all_reduce_mean(grads, metrics):
    """Average the gradients and the metrics over the world with one
    all-reduce of a flattened buffer: the gradients first, the metrics in
    its tail. Returns the averaged metrics (new tensors); the gradients are
    averaged in place."""
    import torch.distributed as dist

    dtype, device = grads[0].dtype, grads[0].device
    values = {k: torch.as_tensor(v, device=device) for k, v in metrics.items()}
    flat = torch.cat([g.reshape(-1) for g in grads] + [v.reshape(-1).to(dtype) for v in values.values()])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n
    out = {}
    for k, v in values.items():
        n = v.numel()
        got = flat[offset:offset + n].view(v.shape)
        out[k] = (got.to(v.dtype) if v.dtype.is_floating_point else got).clone()
        offset += n
    return out


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
