"""Lifecycle spans: context-manager timing around the runtime's phase
boundaries (reservation, node launch, feed waves, checkpoint save/restore,
serving requests), flushed as structured events into the registry.

A span records wall-clock AND monotonic timestamps — wall time orders events
across processes/hosts in the merged cluster view; the monotonic pair is what
the duration is computed from (NTP steps must not corrupt durations). Each
completed span:

* appends an event dict to the registry's bounded event buffer::

      {"span": name, "ts": wall_start, "dur_s": secs, "ok": bool, **attrs}

* observes its duration into the histogram ``{name}_seconds`` — so spans are
  queryable both as individual events (debugging a slow launch) and as
  distributions (p99 checkpoint-save time), and survive the event buffer's
  bounded window.

When the registry is disabled, :func:`span` returns a shared no-op context
manager: no allocation, nothing recorded.
"""

import threading
import time

from tensorflowonspark_tpu_torch.obs import registry as _registry
from tensorflowonspark_tpu_torch.obs import tracing as _tracing


class _NullSpan:
    """Shared do-nothing span handed out while collection is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL = _NullSpan()


class Span:
    __slots__ = ("name", "attrs", "_registry", "_t0_wall", "_t0_mono", "_span_id", "_parent_id")

    def __init__(self, name, registry, attrs):
        self.name = name
        self.attrs = attrs
        self._registry = registry

    def set(self, **attrs):
        """Attach attributes mid-span (e.g. the number of nodes reserved)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        # participate in the cluster trace when a context is installed: the
        # thread-local stack gives this span an id + its parent, so nested
        # spans chain causally across every tier for free
        self._span_id, self._parent_id = _tracing.push_span()
        self._t0_wall = time.time()
        self._t0_mono = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.monotonic() - self._t0_mono
        _tracing.pop_span(self._span_id)
        event = {
            "span": self.name,
            "ts": self._t0_wall,
            "dur_s": dur,
            "ok": exc_type is None,
        }
        if self.attrs:
            event.update(self.attrs)
        if self._span_id is not None:
            event["trace"] = _tracing.trace_id()
            event["span_id"] = self._span_id
            _tracing.record(
                {
                    "kind": "span",
                    "name": self.name,
                    "trace": _tracing.trace_id(),
                    "span": self._span_id,
                    "parent": self._parent_id,
                    "ts": self._t0_wall,
                    "dur_s": dur,
                    "ok": exc_type is None,
                    "tid": threading.get_native_id(),
                    "attrs": dict(self.attrs) if self.attrs else {},
                }
            )
        self._registry.add_event(event)
        self._registry.histogram(
            self.name + "_seconds", help="duration of {} spans".format(self.name)
        ).observe(dur)
        return False  # never swallow exceptions


def span(name, registry=None, **attrs):
    """Open a lifecycle span::

        with obs.span("reservation_roundtrip", nodes=4):
            ...

    ``registry`` defaults to the process-global one. Attribute values must be
    JSON-able (they ride the aggregation plane to the driver).
    """
    reg = registry if registry is not None else _registry.get_registry()
    if not reg._enabled:
        return _NULL
    return Span(name, reg, dict(attrs))
