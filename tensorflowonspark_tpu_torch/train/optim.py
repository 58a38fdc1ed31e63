"""``optax.sgd``, ``optax.adam``, ``optax.adamw`` and the learning-rate schedules the ported
examples use, with optax's semantics, for :class:`~tensorflowonspark_tpu_torch.
train.strategy.SyncDataParallel`.

``sgd(lr, momentum=m)`` is ``optax.chain(trace(m), scale_by_learning_rate(lr))``:
the trace is ``t = g + m·t`` (no dampening, no Nesterov) and the update is
``p += -lr(k)·t``, where ``k`` is the step count *before* this update — so a
``linear_schedule(0, base, warmup)`` takes a zero step first. (torch.optim's
SGD differs in where the learning rate enters the schedule.)

``adamw(lr)`` is ``optax.adamw(lr)`` with optax's defaults: b1 0.9, b2
0.999, eps 1e-8 outside the square root, and weight decay 1e-4 on EVERY
parameter (``mask=None``: norm scales and the embedding decay too), added
to the Adam direction before the learning rate scales it. (torch.optim's
AdamW defaults to a decay of 1e-2.) ``adam(lr)`` is ``optax.adam(lr)``: the
same Adam direction with no decay term.

As in optax, the step count is an int32 array in the optimizer state, on
the parameters' device, and everything derived from it — the learning
rate, AdamW's bias corrections — is computed there in float32 from it, by
schedules written in tensor ops. So an update never reads a number back to
the host, and a step captured in a CUDA graph advances its own count and
learning rate on every replay. Updates run as ``torch._foreach_*`` ops over
all parameters at once (a few launches a step, not a few a parameter),
each op in optax's order.
"""

import torch


def _count(params):
    device = next(iter(params.values())).device if params else "cpu"
    return torch.zeros((), dtype=torch.int32, device=device)


def _rate(learning_rate, count):
    """``learning_rate(count)`` (or the constant) as a float32 tensor on the
    count's device."""
    value = learning_rate(count) if callable(learning_rate) else learning_rate
    if isinstance(value, torch.Tensor):
        return value.to(device=count.device, dtype=torch.float32)
    # a fill, not a copy from the host: capturable
    return torch.full((), value, dtype=torch.float32, device=count.device)


class SGD:
    """Stateless transform: ``init(params)`` makes the state, ``update``
    applies one step to the parameters in place."""

    def __init__(self, learning_rate, momentum=None):
        self.learning_rate = learning_rate
        self.momentum = momentum

    def init(self, params):
        """``params``: ``{name: tensor}``."""
        trace = {n: torch.zeros_like(p) for n, p in params.items()} if self.momentum else None
        return {"count": _count(params), "trace": trace}

    def lr(self, count):
        """The learning rate at ``count`` (a tensor or an int), a float32
        tensor."""
        return _rate(self.learning_rate, torch.as_tensor(count))

    @torch.no_grad()
    def update(self, params, grads, state):
        step_size = -self.lr(state["count"])
        names = list(params)
        g = [grads[n] for n in names]
        if self.momentum:
            t = [state["trace"][n] for n in names]
            torch._foreach_mul_(t, self.momentum)
            torch._foreach_add_(t, g)
            g = t
        torch._foreach_add_([params[n] for n in names], torch._foreach_mul(g, step_size))
        state["count"].add_(1)


def sgd(learning_rate, momentum=None):
    return SGD(learning_rate, momentum)


class AdamW:
    """``optax.chain(scale_by_adam(b1, b2, eps, eps_root),
    add_decayed_weights(weight_decay), scale_by_learning_rate(lr))``:
    ``mu = b1·mu + (1 − b1)·g``, ``nu = b2·nu + (1 − b2)·g²``, both
    bias-corrected with the count after its increment, and
    ``p += −lr(k)·(mû/(√(nû + eps_root) + eps) + weight_decay·p)``, where
    ``k`` is the count before this update. Parameters update in place."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.weight_decay = weight_decay

    def init(self, params):
        """``params``: ``{name: tensor}``."""
        return {"count": _count(params), "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def lr(self, count):
        """The learning rate at ``count`` (a tensor or an int), a float32
        tensor."""
        return _rate(self.learning_rate, torch.as_tensor(count))

    @torch.no_grad()
    def update(self, params, grads, state):
        count = state["count"]
        step_size = -self.lr(count)
        count.add_(1)
        k = count.float()
        bc1, bc2 = 1.0 - torch.pow(self.b1, k), 1.0 - torch.pow(self.b2, k)
        names = list(params)
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2))
        denom = torch._foreach_div(nu, bc2)
        if self.eps_root:
            torch._foreach_add_(denom, self.eps_root)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(mu, bc1)
        torch._foreach_div_(update, denom)
        if self.weight_decay:
            torch._foreach_add_(update, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(update, step_size)
        torch._foreach_add_(p, update)


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4):
    return AdamW(learning_rate, b1, b2, eps, eps_root, weight_decay)


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0):
    """``optax.adam``: ``optax.chain(scale_by_adam(b1, b2, eps, eps_root),
    scale_by_learning_rate(lr))``, :class:`AdamW` without its decay term.
    Its state (``count``, ``mu``, ``nu``) is AdamW's."""
    return AdamW(learning_rate, b1, b2, eps, eps_root, weight_decay=0.0)


def linear_schedule(init_value, end_value, transition_steps, transition_begin=0):
    """``optax.linear_schedule``, in float32 tensor ops on ``count`` (a
    tensor or an int; the result is a float32 tensor on its device)."""

    def schedule(count):
        count = torch.as_tensor(count)
        if transition_steps <= 0:
            return torch.full((), init_value, dtype=torch.float32, device=count.device)
        k = torch.clamp(count - transition_begin, 0, transition_steps).float()
        return (init_value - end_value) * (1.0 - k / transition_steps) + end_value

    return schedule


def piecewise_constant_schedule(init_value, boundaries_and_scales=None):
    """``optax.piecewise_constant_schedule`` in float32 tensor ops: each
    scale applies from its boundary step on."""
    items = sorted((boundaries_and_scales or {}).items())

    def schedule(count):
        count = torch.as_tensor(count)
        v = torch.full((), init_value, dtype=torch.float32, device=count.device)
        for boundary, scale in items:
            v = torch.where(count >= boundary, v * scale, v)
        return v

    return schedule
