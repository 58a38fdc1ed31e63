"""``optax.sgd`` and the learning-rate schedules the ported examples use,
with optax's semantics, for :class:`~tensorflowonspark_tpu_torch.train.
strategy.SyncDataParallel`.

``sgd(lr, momentum=m)`` is ``optax.chain(trace(m), scale_by_learning_rate(lr))``:
the trace is ``t = g + m·t`` (no dampening, no Nesterov) and the update is
``p += -lr(k)·t``, where ``k`` is the step count *before* this update — so a
``linear_schedule(0, base, warmup)`` takes a zero step first. (torch.optim's
SGD differs in where the learning rate enters the schedule.)
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
