"""Pipeline parallelism: GPipe and 1F1B schedules over pipeline stages — the
port of the JAX package's ``parallel/pipeline_parallel.py``.

Absent from the reference (its model parallelism was user-managed TF1
device scopes; no pipeline support), built here in two tiers:

* :func:`pipeline_apply` — GPipe-style pipeline over the ``pp`` mesh axis,
  run once per rank (one process a card): rank i holds stage i, and each of
  the M + P - 1 steps runs its stage on the microbatch it holds, then passes
  the activation to rank i + 1 with a gradient-carrying shift
  (``batch_isend_irecv`` to the axis's neighbours, whose backward shifts the
  cotangent the other way), so the backward is GPipe's, in reverse schedule
  order. With P stages and M microbatches, step t has stage i working on
  microbatch t - i; the bubble fraction is (P-1)/(M+P-1).
  :func:`pipeline_apply_local` runs all P members of that schedule in one
  process, in order (the check on one card: NCCL takes no two ranks on one
  device).

* :class:`Pipeline1F1B` — a host-driven one-forward-one-backward schedule
  (Narayanan et al. 2019 / Megatron's non-interleaved schedule): each stage
  owns a device, a worker thread and a CUDA stream; stage-boundary
  activation/cotangent hops run through the same dedicated comm-thread
  pattern as :class:`~tensorflowonspark_tpu_torch.train.strategy.BucketedOverlap`,
  and the bubble is *measured* from per-op compute spans rather than
  assumed from the closed form (the ``pipeline_bubble_fraction`` gauge,
  with the same spans published as retroactive trace tracks for the merged
  Perfetto timeline).

A stage is ``stage_fn(stage_params, x) -> y`` with ``stage_params`` a dict
of tensors (nested dicts allowed); :func:`module_stage` makes one of a
module through ``torch.func.functional_call``.
"""

import contextlib
import copy
import logging
import queue as queue_mod
import threading
import time

import torch

logger = logging.getLogger(__name__)


def _map(fn, *trees):
    """``fn`` over the leaves of dicts of tensors (nested dicts allowed)."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k])]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure over ``leaves`` (in :func:`_leaves` order)."""
    it = iter(leaves)
    return _map(lambda _: next(it), tree)


def module_stage(module):
    """``stage_fn(params, x)``: ``module(x)`` with its parameters taken from
    ``params`` (``{name: tensor}`` of ``module.named_parameters()``'s names),
    by ``torch.func.functional_call``. That call swaps the module's
    parameters for the call's length, so each thread applies a copy of its
    own (:class:`Pipeline1F1B` runs its stages on threads at once); build
    ``module`` on the ``meta`` device and no copy holds any memory."""
    local = threading.local()

    def stage_fn(params, x):
        mine = getattr(local, "module", None)
        if mine is None:
            mine = local.module = copy.deepcopy(module)
        return torch.func.functional_call(mine, params, (x,))

    return stage_fn


def stack_stage_params(params_list):
    """[per-stage dicts of tensors] → one dict with a leading stage dim of
    size P (each rank of the ``pp`` axis uses its own row)."""
    return _map(lambda *leaves: torch.stack(leaves), *params_list)


def _shift_fn():
    """The gradient-carrying shift along a mesh axis, made at first use."""
    fn = _SHIFT.get("fn")
    if fn is None:
        from tensorflowonspark_tpu_torch.parallel.collectives import ring_shift

        class Shift(torch.autograd.Function):
            @staticmethod
            def forward(ctx, y, axis, mesh):
                ctx.axis, ctx.mesh = axis, mesh
                return ring_shift(y, axis, mesh, 1)

            @staticmethod
            def backward(ctx, g):
                return ring_shift(g.contiguous(), ctx.axis, ctx.mesh, -1), None, None

        fn = _SHIFT["fn"] = Shift.apply
    return fn


_SHIFT = {}


def _gpipe(stage_fn, params, mb, n_pp, idx, shift):
    """One member's GPipe schedule: ``[M, ...]`` outputs (the last stage's,
    zeros on the others)."""
    n_micro = mb.shape[0]
    steps = n_micro + n_pp - 1
    buf = torch.zeros_like(mb[0])
    first = torch.tensor(idx == 0, device=mb.device)
    last = torch.tensor(idx == n_pp - 1, device=mb.device)
    outs = []
    for t in range(steps):
        # stage 0 injects microbatch t (clipped), later stages eat their
        # neighbour's buf. The selects keep every received buf and every
        # output slot on this rank's autograd path, so a loss on the output
        # runs every shift's backward on every rank, in the same order
        x_in = torch.where(first, mb[min(t, n_micro - 1)], buf)
        y = stage_fn(params, x_in)
        # the LAST stage finishes microbatch t-(P-1) at step t
        if t >= n_pp - 1:
            outs.append(torch.where(last, y, torch.zeros_like(y)))
        if t < steps - 1:  # the last step's rotation would feed nothing
            buf = shift(y)
    return torch.stack(outs)


def pipeline_apply(stage_fn, stacked_params, microbatches, mesh, axis="pp", batch_axis=None):
    """Run ``stage_fn`` as a P-stage pipeline over the mesh's ``axis``, on
    this rank's stage.

    ``stage_fn(stage_params, x) -> y`` is ONE stage's computation; every
    stage must map the same activation shape to itself (classic homogeneous
    pipeline). ``stacked_params`` has a leading stage dim of size P
    (:func:`stack_stage_params`), the same on every rank; rank i of the axis
    uses row i. ``microbatches`` is ``[M, ...]`` (split a global batch with
    :func:`split_microbatches`), the same on every rank. Returns the ``[M,
    ...]`` outputs on every rank: the last stage's, summed over the axis
    with the others' zeros (an all-reduce whose backward is the identity,
    ``collectives.reduce_from_region``), so that a loss every rank computes
    on them gives each stage's gradient once, equal to the sequential
    composition's.

    ``batch_axis`` composes the pipeline with data parallelism on one mesh:
    the within-microbatch dim (dim 1) is split over that axis, so a
    ``{"dp": D, "pp": P}`` mesh runs D activation shards through P stages
    concurrently — each dp column owns its slice end to end, the stage hops
    stay within the column, and the output is gathered whole. A stage's
    gradient is summed over the axis's ranks (``copy_to_region`` on its
    row), as the gradient of the global loss is.
    """
    from tensorflowonspark_tpu_torch.parallel import collectives
    from tensorflowonspark_tpu_torch.parallel.mesh import mesh_shape

    sizes = mesh_shape(mesh)
    n_pp = sizes[axis]
    if next(iter(_leaves(stacked_params))).shape[0] != n_pp:
        raise ValueError("stacked params have {} stages, the mesh's {!r} axis {}".format(
            next(iter(_leaves(stacked_params))).shape[0], axis, n_pp))
    idx = collectives.axis_index(axis, mesh)
    params = _map(lambda a: a[idx], stacked_params)
    mb = microbatches
    data = collectives.axes_group(mesh, batch_axis) if batch_axis and sizes.get(batch_axis, 1) > 1 else None
    if data is not None:
        params = _map(lambda a: collectives.copy_to_region(a, data), params)
        mb = collectives.split_to_region(mb, data, dim=1)
    shift = _shift_fn()
    out = _gpipe(stage_fn, params, mb, n_pp, idx, lambda y: shift(y, axis, mesh))
    out = collectives.reduce_from_region(out, collectives.axes_group(mesh, axis))
    if data is not None:
        out = collectives.gather_from_region(out, data, dim=1)
    return out


def pipeline_apply_local(stage_fn, stacked_params, microbatches):
    """All P members of :func:`pipeline_apply`'s schedule in this process,
    in order: at each of the M + P - 1 steps every stage runs on what the
    previous step handed it, and the hop is a hand-over in memory. The same
    outputs, through autograd the same gradients, as P ranks (the check on
    one card)."""
    n_pp = next(iter(_leaves(stacked_params))).shape[0]
    params = [_map(lambda a, i=i: a[i], stacked_params) for i in range(n_pp)]
    n_micro = microbatches.shape[0]
    bufs = [torch.zeros_like(microbatches[0])] * n_pp
    outs = []
    for t in range(n_micro + n_pp - 1):
        ys = [stage_fn(params[i], microbatches[min(t, n_micro - 1)] if i == 0 else bufs[i])
              for i in range(n_pp)]
        if t >= n_pp - 1:
            outs.append(ys[-1])
        bufs = [None] + ys[:-1]
    return torch.stack(outs)


def split_microbatches(x, n_micro):
    """[B, ...] → [n_micro, B//n_micro, ...]."""
    if x.shape[0] % n_micro:
        raise ValueError(
            "batch {} not divisible into {} microbatches".format(x.shape[0], n_micro)
        )
    return x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))


def merge_microbatches(y):
    """Inverse of :func:`split_microbatches`."""
    return y.reshape((-1,) + tuple(y.shape[2:]))


def schedule_1f1b(stage, n_stages, n_micro):
    """The 1F1B op order for one stage: ``[("F", m) | ("B", m), ...]``.

    ``n_stages - 1 - stage`` warmup forwards, then alternating F/B in
    steady state, then cooldown backwards — each stage holds at most
    ``n_stages - stage`` activation stashes in flight, which is the whole
    point of 1F1B over GPipe's all-forwards-then-all-backwards. The last
    stage's pairs are fused by :class:`Pipeline1F1B` into single loss+vjp
    ops, but the order here is the canonical schedule for every stage.
    """
    warmup = min(n_stages - 1 - stage, n_micro)
    ops = [("F", m) for m in range(warmup)]
    f = warmup
    b = 0
    while f < n_micro:
        ops.append(("F", f))
        f += 1
        ops.append(("B", b))
        b += 1
    while b < n_micro:
        ops.append(("B", b))
        b += 1
    return ops


class Pipeline1F1B:
    """Host-driven 1F1B microbatch pipeline with measured bubble accounting.

    ``stage_fn(stage_params, x) -> y`` is one stage's computation (same
    homogeneous contract as :func:`pipeline_apply`); ``params_list`` holds P
    per-stage dicts of tensors, each placed on its stage's device;
    ``loss_fn(y, target) -> scalar`` closes the last stage. One optimizer
    step::

        sched = Pipeline1F1B(stage_fn, params_list, loss_fn)
        loss, grads = sched.step(split_microbatches(x, M),
                                 split_microbatches(t, M))
        # grads[i] lives on stage i's device, scaled to d(mean loss)/dparams

    ``devices`` defaults to the visible CUDA devices; any list of at least P
    devices is taken, one naming the same card P times too (the stages then
    share it, each on its own stream). ``stage_fn`` runs on P threads at
    once, so it must not swap state on a shared module (:func:`module_stage`
    keeps a copy a thread).

    Execution: one worker thread per stage runs :func:`schedule_1f1b` on
    its own CUDA stream. A forward op runs without autograd; a backward op
    re-runs the stage forward under autograd from the stashed input and
    takes ``torch.autograd.grad(y, (params, x), g)`` (activation
    rematerialization — only the stage *inputs* are stashed, at most ``P -
    stage`` of them, which is 1F1B's memory contract; no forward graph is
    kept). The last stage fuses each microbatch's loss and backward into one
    op. Gradients are summed in schedule order and scaled by 1/M.
    Stage-boundary activation/cotangent hops go through a dedicated comm
    thread — the :class:`~tensorflowonspark_tpu_torch.train.strategy.
    BucketedOverlap` pattern: it waits on a CUDA event of the producing
    stream (not a device sync) *beside* the next op's compute, then copies
    the buffer to the neighbour's device on a copy stream. ``overlap=False``
    runs the identical transfers inline on the stage threads (same buffers,
    same order, host-side fencing only), the measured-off leg.

    Measurement: every op's launch-to-done interval is recorded per stage.
    ``pipeline_bubble_fraction`` = 1 - busy/(P × window) over the step's
    wall window — the *measured* counterpart of the closed form
    (P-1)/(2M+P-1), visible per step in :attr:`last_stats` and the gauge.
    Transfer seconds that land inside some stage's compute span count as
    hidden; the ``pipeline_comm_overlap_fraction`` gauge reports the
    fraction. With tracing active both land as retroactive spans
    (``pipeline_stage`` / ``pipeline_transfer`` tracks).
    """

    def __init__(self, stage_fn, params_list, loss_fn, devices=None, overlap=True):
        if not params_list:
            raise ValueError("need at least one pipeline stage")
        self.stage_fn = stage_fn
        self.loss_fn = loss_fn
        self.overlap = overlap
        self.n_stages = len(params_list)
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        if len(devices) < self.n_stages:
            raise ValueError(
                "{} pipeline stages need {} devices; have {}".format(
                    self.n_stages, self.n_stages, len(devices)
                )
            )
        self.devices = devices[: self.n_stages]
        self.params = [
            _map(lambda a, d=d: a.detach().to(d).requires_grad_(), p)
            for p, d in zip(params_list, self.devices)
        ]
        self.last_stats = {}
        # a stream a stage and a copy stream a device, kept across steps:
        # the caching allocator pools memory by stream, so fresh streams
        # every step would allocate every step's buffers anew
        self._streams = [torch.cuda.Stream(d) if d.type == "cuda" else None for d in self.devices]
        self._copy_streams = {}
        # bounded: a wedged comm thread should exert backpressure on the
        # stage workers instead of accumulating device buffers in the queue
        self._jobs = queue_mod.Queue(maxsize=max(8, 4 * self.n_stages))
        self._comm_worker = None
        self._comm_err = None

    # -- the ops -----------------------------------------------------------

    def _fwd(self, i, x):
        with torch.no_grad():
            return self.stage_fn(self.params[i], x)

    def _bwd(self, i, x, g):
        """(dparams, dx) of stage ``i`` at ``x`` against the cotangent
        ``g``, from the stage forward re-run under autograd (dx None for
        stage 0)."""
        leaves = _leaves(self.params[i])
        with torch.enable_grad():
            xr = x.detach().requires_grad_(i > 0)
            y = self.stage_fn(self.params[i], xr)
            got = torch.autograd.grad(y, leaves + [xr] * (i > 0), g)
        return list(got[: len(leaves)]), (got[-1] if i > 0 else None)

    def _last(self, x, target):
        """Fused loss+vjp op of the final stage (its F/B pair)."""
        i = self.n_stages - 1
        leaves = _leaves(self.params[i])
        with torch.enable_grad():
            xr = x.detach().requires_grad_(i > 0)
            loss = self.loss_fn(self.stage_fn(self.params[i], xr), target)
            got = torch.autograd.grad(loss, leaves + [xr] * (i > 0))
        return loss.detach(), list(got[: len(leaves)]), (got[-1] if i > 0 else None)

    # -- comm thread (BucketedOverlap pattern) -----------------------------

    def _copy_stream(self, device):
        stream = self._copy_streams.get(device)
        if stream is None:
            stream = self._copy_streams[device] = torch.cuda.Stream(device)
        return stream

    def _transfer(self, payload, ready, dest, out_q, tag, spans):
        t0 = time.perf_counter()
        if ready is not None:
            ready.synchronize()  # the producing stream's event, not the device
        t1 = time.perf_counter()
        if dest.type == "cuda":
            stream = self._copy_stream(dest)
            with torch.cuda.device(dest), torch.cuda.stream(stream):
                moved = torch.empty_like(payload, device=dest)
                moved.copy_(payload, non_blocking=True)
                landed = torch.cuda.Event()
                landed.record(stream)
            landed.synchronize()
        else:
            moved = payload.to(dest, copy=True)
        t2 = time.perf_counter()
        spans.append((t1, t2, tag))
        out_q.put((tag[1], moved))

    def _comm_loop(self):
        while True:
            job = self._jobs.get()
            if job is None:
                return
            try:
                self._transfer(*job)
            except BaseException as e:  # surfaces at the step join
                self._comm_err = e
                job[3].put((job[4][1], e))
            job = None

    def _ensure_comm_worker(self):
        if self._comm_worker is None or not self._comm_worker.is_alive():
            self._comm_worker = threading.Thread(
                target=self._comm_loop, name="pipeline-comm", daemon=True
            )
            self._comm_worker.start()

    # -- the step ----------------------------------------------------------

    def step(self, microbatches, targets):
        """One step over ``microbatches`` (``[M, b, ...]`` from
        :func:`split_microbatches`) and matching per-microbatch ``targets``
        (``[M, ...]``, or a dict of such tensors). Returns ``(loss,
        grads)``: the microbatch-mean loss and per-stage gradient dicts
        scaled to match ``grad(mean loss)``."""
        P = self.n_stages
        M = int(microbatches.shape[0])
        if M < 1:
            raise ValueError("step needs at least one microbatch")
        if self.overlap:
            self._ensure_comm_worker()
        # ingest: land inputs on the edge devices before the measured window
        mbs = [microbatches[m].to(self.devices[0]) for m in range(M)]
        tgts = [_map(lambda t, m=m: t[m].to(self.devices[-1]), targets) for m in range(M)]
        cuda = any(d.type == "cuda" for d in self.devices)
        if cuda:
            for d in set(self.devices):
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
        streams = self._streams

        acts = [queue_mod.Queue() for _ in range(P)]
        grads_q = [queue_mod.Queue() for _ in range(P)]
        compute_spans = [[] for _ in range(P)]  # (t0, t1, op, m) per stage
        comm_spans = []  # (t0, t1, (kind, m, src)) — comm thread + inline
        losses = [None] * M
        grad_acc = [None] * P
        stash_peak = [0] * P
        errs = [None] * P

        def _send(payload, ready, dest_stage, out_q, tag):
            job = (payload, ready, self.devices[dest_stage], out_q, tag, comm_spans)
            if self.overlap:
                self._jobs.put(job)
            else:
                self._transfer(*job)

        def _recv(q, m):
            got_m, payload = q.get()
            if isinstance(payload, BaseException):
                raise RuntimeError("pipeline transfer failed") from payload
            if got_m != m:
                raise RuntimeError(
                    "pipeline schedule out of order: wanted microbatch "
                    "{}, got {}".format(m, got_m)
                )
            if payload.is_cuda:  # landed on the copy stream, read on this one
                payload.record_stream(torch.cuda.current_stream(payload.device))
            return payload

        def _done(i):
            """Wait for stage ``i``'s op: its event (None on the CPU)."""
            if streams[i] is None:
                return None
            ev = torch.cuda.Event()
            ev.record(streams[i])
            ev.synchronize()
            return ev

        def _accumulate(i, dp):
            grad_acc[i] = dp if grad_acc[i] is None else [a + b for a, b in zip(grad_acc[i], dp)]

        def _run_stage(i):
            scope = contextlib.ExitStack()
            try:
                with scope:
                    if streams[i] is not None:
                        scope.enter_context(torch.cuda.device(self.devices[i]))
                        scope.enter_context(torch.cuda.stream(streams[i]))
                    stash = {}
                    for op, m in schedule_1f1b(i, P, M):
                        if i == P - 1:
                            if op == "B":
                                continue  # fused into the F slot's loss+vjp op
                            x = mbs[m] if P == 1 else _recv(acts[i], m)
                            t0 = time.perf_counter()
                            loss, dp, dx = self._last(x, tgts[m])
                            _accumulate(i, dp)
                            ready = _done(i)
                            t1 = time.perf_counter()
                            compute_spans[i].append((t0, t1, "fb", m))
                            losses[m] = loss
                            if P > 1:
                                _send(dx, ready, i - 1, grads_q[i - 1], ("grad", m, i))
                        elif op == "F":
                            x = mbs[m] if i == 0 else _recv(acts[i], m)
                            stash[m] = x
                            stash_peak[i] = max(stash_peak[i], len(stash))
                            t0 = time.perf_counter()
                            y = self._fwd(i, x)
                            ready = _done(i)
                            t1 = time.perf_counter()
                            compute_spans[i].append((t0, t1, "fwd", m))
                            _send(y, ready, i + 1, acts[i + 1], ("act", m, i))
                        else:  # backward: re-run the stage from its stashed input
                            g = _recv(grads_q[i], m)
                            x = stash.pop(m)
                            t0 = time.perf_counter()
                            dp, dx = self._bwd(i, x, g)
                            _accumulate(i, dp)
                            ready = _done(i)
                            t1 = time.perf_counter()
                            compute_spans[i].append((t0, t1, "bwd", m))
                            if i > 0:
                                _send(dx, ready, i - 1, grads_q[i - 1], ("grad", m, i))
            except BaseException as e:
                errs[i] = e
                # unblock neighbours waiting on this stage's sends
                if i + 1 < P:
                    acts[i + 1].put((-1, e))
                if i > 0:
                    grads_q[i - 1].put((-1, e))

        workers = [
            threading.Thread(
                target=_run_stage, args=(i,), name="pipeline-stage-{}".format(i),
                daemon=True,  # a wedged device call must not pin interpreter exit
            )
            for i in range(P)
        ]
        for w in workers:
            w.start()
        for w in workers:
            # the error path unblocks neighbours, so every stage terminates;
            # bounded join slices keep a wedged device call diagnosable
            while w.is_alive():
                w.join(timeout=60.0)
        for i, e in enumerate(errs):
            if e is not None:
                raise RuntimeError("pipeline stage {} failed".format(i)) from e
        if self._comm_err is not None:
            err, self._comm_err = self._comm_err, None
            raise RuntimeError("pipeline comm thread failed") from err

        scale = 1.0 / M
        grads = [_rebuild(self.params[i], [g * scale for g in acc]) for i, acc in enumerate(grad_acc)]
        loss = torch.stack([l.to(self.devices[-1]) for l in losses]).mean()
        self._publish(compute_spans, comm_spans, M, stash_peak)
        return loss, grads

    # -- measurement -------------------------------------------------------

    def _publish(self, compute_spans, comm_spans, n_micro, stash_peak):
        """Span accounting → last_stats + gauges + retroactive trace spans."""
        from tensorflowonspark_tpu_torch import obs
        from tensorflowonspark_tpu_torch.obs import tracing as obs_tracing

        P = self.n_stages
        all_spans = [s for spans in compute_spans for s in spans]
        t_first = min(s[0] for s in all_spans)
        t_last = max(s[1] for s in all_spans)
        window = max(t_last - t_first, 1e-9)
        busy = sum(t1 - t0 for t0, t1, _op, _m in all_spans)
        bubble = max(0.0, 1.0 - busy / (P * window))

        # merge compute spans into a busy-interval union; transfer seconds
        # inside it ran beside some stage's compute — hidden comm
        union = []
        for t0, t1, _op, _m in sorted(all_spans):
            if union and t0 <= union[-1][1]:
                union[-1] = (union[-1][0], max(union[-1][1], t1))
            else:
                union.append((t0, t1))
        comm_busy = sum(t1 - t0 for t0, t1, _tag in comm_spans)
        hidden = 0.0
        for t0, t1, _tag in comm_spans:
            for u0, u1 in union:
                hidden += max(0.0, min(t1, u1) - max(t0, u0))
        overlap_fraction = min(1.0, hidden / comm_busy) if comm_busy > 0 else 0.0

        self.last_stats = {
            "n_stages": P,
            "n_microbatches": n_micro,
            "window_s": window,
            "busy_s": busy,
            "bubble_fraction": bubble,
            "bubble_fraction_theory": (P - 1.0) / (2.0 * n_micro + P - 1.0),
            "comm_busy_s": comm_busy,
            "hidden_comm_s": hidden,
            "overlap_fraction": overlap_fraction,
            "stash_peak": list(stash_peak),
        }
        obs.gauge(
            "pipeline_bubble_fraction",
            help="measured idle fraction of the 1F1B pipeline window "
            "(1 - stage busy seconds / (stages x window))",
        ).set(bubble)
        obs.gauge(
            "pipeline_comm_overlap_fraction",
            help="fraction of stage-boundary transfer time hidden behind "
            "pipeline stage compute",
        ).set(overlap_fraction)
        if obs_tracing.active():
            # publish the measured intervals as retroactive spans (one track
            # per plane, like BucketedOverlap's comm tracks) so tracemerge's
            # timeline corroborates the bubble/overlap gauges
            anchor = time.time() - time.perf_counter()
            for i, spans in enumerate(compute_spans):
                for t0, t1, op, m in spans:
                    obs_tracing.record_span(
                        "pipeline_stage", ts=anchor + t0, dur_s=t1 - t0,
                        track="pipeline", stage=i, op=op, microbatch=m,
                    )
            for t0, t1, (kind, m, src) in comm_spans:
                obs_tracing.record_span(
                    "pipeline_transfer", ts=anchor + t0, dur_s=t1 - t0,
                    track="pipeline_comm", kind=kind, microbatch=m, stage=src,
                )

    def close(self):
        """Stop the comm thread (idempotent)."""
        if self._comm_worker is not None and self._comm_worker.is_alive():
            self._jobs.put(None)
            self._comm_worker.join(timeout=10)
        self._comm_worker = None
