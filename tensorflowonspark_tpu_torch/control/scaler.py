"""The cluster-level member of the controller family: target world size.

The recovery ladder (:func:`~tensorflowonspark_tpu_torch.elastic.run_ladder`)
shrinks reactively — a failure costs capacity the moment the ledger
condemns it. Growing back is a *choice*, and a bad one is expensive: a
regrow restart drains and relaunches the whole cluster, so flapping on a
node that is about to die again costs more than training small for one
more interval. :class:`ClusterScaler` is that choice expressed through the
shared :class:`~tensorflowonspark_tpu_torch.control.core.Controller` discipline,
inverted from the per-process tuners: **down immediately** (the capacity
is already gone; refusing to acknowledge it helps nobody) and **up only
after ``grow_patience`` consecutive healthy verdicts** (a returning
executor must stay probe-healthy across intervals before the ladder pays
for a restart).

The grow gate also consults the same stall/throughput classification the
per-process tuners reason from
(:func:`~tensorflowonspark_tpu_torch.control.core.classify_stalls`): when the
last interval was input-bound (``io_bound`` / ``decode_bound``), more
workers on the same starved input path buy nothing — regrow is deferred
until the input path recovers or the verdict ages out. ``device_bound``
(or no stall data at all, the common case between intervals) means compute
is the gate, and more compute helps.

Publishes the ``target_world_size`` gauge on every verdict so the merged
metrics always show where the scaler is steering, not just where the
cluster currently is.
"""

import logging

from tensorflowonspark_tpu_torch import obs
from tensorflowonspark_tpu_torch.control.core import Controller

logger = logging.getLogger(__name__)

#: stall verdicts under which adding workers cannot raise throughput: the
#: input path, not compute, is the gate
INPUT_BOUND = frozenset({"io_bound", "decode_bound"})


class ClusterScaler:
    """Choose the target executor count for the recovery ladder.

    ``full_size`` is the job's requested world; ``min_size`` the floor the
    ladder enforces anyway. :meth:`decide` is called from the ladder's
    regrow poll with the *current* size, the size the re-probed capacity
    argues for (``desired``, usually ``plan_size`` after forgiveness), and
    the latest stall classification; it returns the size the discipline
    allows right now. One rung per verdict: the gate decides *whether* to
    pay for a restart — the relaunch itself regrows to the full re-probed
    plan.
    """

    def __init__(self, full_size, min_size=1, grow_patience=2, name="cluster"):
        self.full_size = int(full_size)
        self.min_size = max(1, int(min_size))
        self._ctl = Controller(
            lo=self.min_size, hi=self.full_size,
            up_patience=grow_patience, down_patience=1, name=name,
        )
        self._target_g = obs.gauge(
            "target_world_size",
            help="executor count the cluster scaler is currently steering toward",
        )

    @property
    def grow_patience(self):
        return self._ctl.up_patience

    def decide(self, current, desired, classification=None):
        """One scaling verdict; returns the allowed next world size."""
        if desired > current and classification in INPUT_BOUND:
            # more mouths on a starved input path help nothing: hold, and
            # clear any accumulated grow credit — the cluster must be
            # healthy AND compute-bound across the whole patience window
            self._ctl.reset()
            target = current
        else:
            want = (desired > current) - (desired < current)
            target = self._ctl.step(current, want)
        if target != current:
            logger.info(
                "cluster scaler: %d -> %d executor(s) (desired %d, %s)",
                current, target, desired, classification or "no stall data",
            )
        self._target_g.set(target)
        return target

    def observe(self, actual):
        """Snap to a size the ladder imposed outside a verdict (a failure
        shrink): clear the streaks — the regime changed — and republish the
        gauge so the metrics never show a stale target."""
        self._ctl.reset()
        self._target_g.set(int(actual))
