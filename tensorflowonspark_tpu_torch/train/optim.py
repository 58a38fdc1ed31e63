"""``optax.sgd``, ``optax.adamw`` and the learning-rate schedules the ported
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
AdamW defaults to a decay of 1e-2.)
"""

import torch


class SGD:
    """Stateless transform: ``init(params)`` makes the state, ``update``
    applies one step to the parameters in place."""

    def __init__(self, learning_rate, momentum=None):
        self.learning_rate = learning_rate
        self.momentum = momentum

    def init(self, params):
        """``params``: ``{name: tensor}``."""
        trace = {n: torch.zeros_like(p) for n, p in params.items()} if self.momentum else None
        return {"count": 0, "trace": trace}

    def lr(self, count):
        return float(self.learning_rate(count) if callable(self.learning_rate) else self.learning_rate)

    @torch.no_grad()
    def update(self, params, grads, state):
        step_size = -self.lr(state["count"])
        for name, p in params.items():
            g = grads[name]
            if self.momentum:
                t = state["trace"][name]
                t.mul_(self.momentum).add_(g)
                g = t
            p.add_(g * step_size)
        state["count"] += 1


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
        return {"count": 0, "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def lr(self, count):
        return float(self.learning_rate(count) if callable(self.learning_rate) else self.learning_rate)

    @torch.no_grad()
    def update(self, params, grads, state):
        step_size = -self.lr(state["count"])
        count = state["count"] + 1
        bc1, bc2 = 1.0 - self.b1 ** count, 1.0 - self.b2 ** count
        for name, p in params.items():
            g = grads[name]
            mu, nu = state["mu"][name], state["nu"][name]
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            direction = (mu / bc1) / (torch.sqrt(nu / bc2 + self.eps_root) + self.eps)
            p.add_(direction + self.weight_decay * p, alpha=step_size)
        state["count"] = count


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4):
    return AdamW(learning_rate, b1, b2, eps, eps_root, weight_decay)


def linear_schedule(init_value, end_value, transition_steps, transition_begin=0):
    """``optax.linear_schedule``."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        k = min(max(count - transition_begin, 0), transition_steps)
        return (init_value - end_value) * (1 - k / transition_steps) + end_value

    return schedule


def piecewise_constant_schedule(init_value, boundaries_and_scales=None):
    """``optax.piecewise_constant_schedule``: each scale applies from its
    boundary step on."""
    items = sorted((boundaries_and_scales or {}).items())

    def schedule(count):
        v = init_value
        for boundary, scale in items:
            if count >= boundary:
                v *= scale
        return v

    return schedule
