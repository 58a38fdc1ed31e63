"""Synchronous data parallelism over ``torch.distributed`` — the port of the
JAX package's ``train/strategy.py``.

There the strategy owns a device mesh and XLA derives the gradient
all-reduce from shardings. Here each process owns one device and a full
replica: batches are placed on ``ctx.device``, and with more than one
process the gradients are averaged with one all-reduce per step before the
optimizer runs, so every replica takes the same update and parameters stay
bit-identical across ranks. The parameters are broadcast from rank 0 when
the state is created.

The step contract is the JAX version's (``mutable`` / ``has_aux`` /
``step=``), with the ``nn.Module`` in the place of the params pytree: the
module holds the parameters, and the step updates parameters, optimizer
state and BN running statistics in place (PyTorch's eager form of the JAX
version's donated state).
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


def _world():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


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
        if _world() > 1:
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
        reading one waits for the step. The step's phases are profiler
        ranges (``train_step.forward``, ``.backward``, ``.optimizer``).
        """
        try:
            wants_step = "step" in inspect.signature(loss_fn).parameters
        except (TypeError, ValueError):
            wants_step = False

        def train_step(state, batch):
            module = state.module
            module.train()
            kw = {"step": state.step} if wants_step else {}
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
                if _world() > 1:
                    _all_reduce_mean(list(grads.values()))
                optimizer.update(params, grads, state.opt_state)
            state.step += 1
            metrics = {"loss": loss.detach(), "step": state.step}
            if aux:
                metrics.update(aux)
            return state, metrics

        return train_step

    def compile_train_loop(self, *args, **kwargs):
        raise NotImplementedError(
            "compile_train_loop (K steps per dispatch) is not yet ported to "
            "tensorflowonspark_tpu_torch; call the compile_train_step step K times"
        )


def _adopt_model_state(module, model_state):
    """Copy a loss function's returned model state into the module's
    buffers (a no-op for the usual in-place update of those buffers)."""
    buffers = dict(module.named_buffers())
    with torch.no_grad():
        for name, value in model_state.items():
            if value is not buffers[name]:
                buffers[name].copy_(value)


def _all_reduce_mean(grads):
    """Average the gradients over the world with one all-reduce of a
    flattened buffer."""
    import torch.distributed as dist

    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n
