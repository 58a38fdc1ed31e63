"""What ran on the card during a block of code, read from a ``torch.profiler``
trace.

Each kernel wrapper of the port counts its own calls in ``launches``: one a
call, whether the call launches its kernel at once or, while a CUDA graph is
being captured, into the graph. A replayed graph runs its kernels again
without calling any wrapper, so what the card ran is counted here, from the
profiler's device trace, by kernel name (each wrapper's ``kernel_names``).

:class:`KernelTrace` traces a block, ends it with a device sync and reads:
the device kernels of each counted wrapper, all device kernels, the CUDA
graph launches, the device's busy time (the union of the kernel intervals),
the block's length and so the device's idle share, and the host time spent
in named ``record_function`` ranges (a trainer's ``train.fetch``,
``train.call`` and ``train.sync``, and the input placement's
``loader.place`` within them).
"""

import collections
import re

import torch

#: the ``record_function`` ranges of a trainer's call that a trace times
CALL_RANGES = ("train.fetch", "train.call", "train.sync", "loader.place")
_WINDOW = "kernel_trace.window"


def kernel_base(name):
    """The bare function name of a device kernel as the profiler names it:
    ``void ns::bn_stats_kernel<__nv_bfloat16>(float const*, int)`` gives
    ``bn_stats_kernel``; a Triton kernel's name is already bare."""
    name = re.split(r"[<(]", name.replace("(anonymous namespace)", ""), maxsplit=1)[0].strip()
    return name.rsplit("::", 1)[-1].split()[-1] if name else name


def union_us(intervals):
    """Total length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for lo, hi in sorted(intervals):
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total


def counted_wrappers():
    """Every kernel wrapper of the port that counts its calls."""
    from tensorflowonspark_tpu_torch.ops import flash_attention, fused_bn

    return fused_bn.COUNTED + flash_attention.KERNELS


def read_events(events, ranges=CALL_RANGES):
    """The readings of :class:`KernelTrace` from a trace's events, which
    must hold one ``kernel_trace.window`` range."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda and not getattr(e, "is_user_annotation", False)]
    host = [e for e in events if e.device_type != cuda]
    window_us = next(e for e in host if e.name == _WINDOW).time_range.elapsed_us()
    by_name = collections.Counter(kernel_base(e.name) for e in kernels)
    busy_us = union_us([(e.time_range.start, e.time_range.end) for e in kernels])
    return {
        "launches": {fn.__name__: sum(by_name[k] for k in fn.kernel_names) for fn in counted_wrappers()},
        "kernels": len(kernels),
        "graph_launches": sum(e.name == "cudaGraphLaunch" for e in host),
        "busy_ms": busy_us / 1e3,
        "window_ms": window_us / 1e3,
        "idle_share": 1.0 - busy_us / window_us if window_us > 0 else None,
        "host_ms": {r: sum(e.time_range.elapsed_us() for e in host if e.name == r) / 1e3 for r in ranges},
    }


class KernelTrace:
    """``with KernelTrace() as trace: ...`` traces the block with
    ``torch.profiler`` (the host, and the card when there is one), ends it
    with a device sync, and leaves :func:`read_events`' readings in
    ``trace.readings``: ``launches`` (``{wrapper name: device kernels}``),
    ``kernels``, ``graph_launches``, ``busy_ms``, ``window_ms``,
    ``idle_share`` and ``host_ms`` (``{range: ms}`` of ``ranges``)."""

    def __init__(self, ranges=CALL_RANGES):
        self.ranges = tuple(ranges)
        self.readings = None

    def __enter__(self):
        self._cuda = torch.cuda.is_available()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self._cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.__enter__()
        self._window = torch.profiler.record_function(_WINDOW)
        self._window.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            if self._cuda:
                torch.cuda.synchronize()
        finally:
            self._window.__exit__(exc_type, exc, tb)
            self._prof.__exit__(exc_type, exc, tb)
        if exc_type is None:
            self.readings = read_events(self._prof.events(), self.ranges)
        return False
