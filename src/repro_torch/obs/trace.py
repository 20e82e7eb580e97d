"""Structured trace spans with cross-process parent/child links.

A :class:`Span` is one timed operation; spans nest through an ambient
current-span context (a :mod:`contextvars` variable, so fan-out threads
that run under a copied context parent correctly).  A span's identity is
``(trace_id, span_id, parent_id)`` — ids are allocated from a pid-salted
counter, so spans created in different processes never collide and one
``insert_batch`` renders as a single tree:

    coordinator op span
      └─ wire span (per shard, in the transport)
           └─ shard-side span (recorded in the worker, shipped back)

The process boundary is crossed with plain dicts: :meth:`Span.wire_ctx`
is injected into the message header by the codec, the worker's tracer
:meth:`Tracer.adopt`\\ s it so server-side spans parent under the wire
span, and the finished spans travel back as :meth:`Tracer.drain_export`
summaries that the client :meth:`Tracer.ingest`\\ s.

Both ends of a span are read from ``time.time_ns()``, the clock that
``torch.profiler``'s events carry, and a span records the OS thread it
ran on (``tid``, ``threading.get_native_id()``), so the spans of every
thread can be joined with a device trace by time.  Neither field is
part of :meth:`Span.export`, whose summaries (µs ``ts`` / ``dur``) stay
those of ``repro.obs``.

Buffers are bounded: past ``capacity`` finished spans are counted in
``dropped`` instead of stored, so tracing a long run degrades to a
truncated dump, never to unbounded memory.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

#: ambient current span (shared module-wide so spans parent across
#: components — e.g. a serving-engine span over a coordinator span)
_CURRENT: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "repro_obs_current_span", default=None)

_SEQ = itertools.count(1)


def _new_id() -> int:
    """Process-unique span id: pid-salted counter (no randomness)."""
    return ((os.getpid() & 0xFFFFF) << 40) | next(_SEQ)


class Span:
    __slots__ = ("name", "trace_id", "span_id", "parent_id",
                 "ts_us", "dur_us", "proc", "attrs", "start_ns", "end_ns",
                 "tid")

    def __init__(self, name: str, trace_id: int, span_id: int,
                 parent_id: Optional[int], proc: str,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.proc = proc
        self.attrs: Dict[str, Any] = attrs or {}
        self.ts_us = 0.0
        self.dur_us = 0.0
        #: epoch nanoseconds (``time.time_ns()``) of the span's two ends
        self.start_ns = 0
        self.end_ns = 0
        #: the OS thread the span ran on; None for a span ingested from
        #: an export, which does not carry it
        self.tid: Optional[int] = None

    def wire_ctx(self) -> Dict[str, int]:
        """Trace context for a service message header."""
        return {"t": self.trace_id, "s": self.span_id}

    def export(self) -> Dict[str, Any]:
        return {"name": self.name, "trace": self.trace_id,
                "span": self.span_id, "parent": self.parent_id,
                "ts": self.ts_us, "dur": self.dur_us, "proc": self.proc,
                "args": self.attrs}

    @classmethod
    def from_export(cls, d: Dict[str, Any]) -> "Span":
        sp = cls(d["name"], d["trace"], d["span"], d.get("parent"),
                 d.get("proc", "?"), dict(d.get("args") or {}))
        sp.ts_us = float(d["ts"])
        sp.dur_us = float(d["dur"])
        sp.start_ns = round(sp.ts_us * 1e3)
        sp.end_ns = sp.start_ns + round(sp.dur_us * 1e3)
        return sp


class _Remote:
    """Stand-in parent for a span adopted from another process."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: int, span_id: int):
        self.trace_id = trace_id
        self.span_id = span_id


class Tracer:
    enabled = True

    def __init__(self, proc: str = "main", capacity: int = 100_000):
        self.proc = proc
        self.capacity = capacity
        self.spans: List[Span] = []
        self.dropped = 0

    # ------------------------------------------------------------------ #
    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Span]:
        """Record a span around the ``with`` block.  A span started while
        another is current becomes its child; otherwise it roots a new
        trace."""
        parent = _CURRENT.get()
        sid = _new_id()
        if parent is None:
            sp = Span(name, sid, sid, None, self.proc, attrs)
        else:
            sp = Span(name, parent.trace_id, sid, parent.span_id,
                      self.proc, attrs)
        sp.tid = threading.get_native_id()
        sp.start_ns = time.time_ns()
        sp.ts_us = sp.start_ns / 1e3
        token = _CURRENT.set(sp)
        try:
            yield sp
        finally:
            sp.end_ns = time.time_ns()
            _CURRENT.reset(token)
            sp.dur_us = (sp.end_ns - sp.start_ns) / 1e3
            if len(self.spans) < self.capacity:
                self.spans.append(sp)
            else:
                self.dropped += 1

    @contextlib.contextmanager
    def adopt(self, ctx: Dict[str, int]) -> Iterator[None]:
        """Parent the block's spans under a remote wire context."""
        token = _CURRENT.set(_Remote(int(ctx["t"]), int(ctx["s"])))
        try:
            yield
        finally:
            _CURRENT.reset(token)

    def context(self) -> Optional[Dict[str, int]]:
        """Wire context of the ambient current span, if any."""
        cur = _CURRENT.get()
        return None if cur is None else {"t": cur.trace_id, "s": cur.span_id}

    # ------------------------------------------------------------------ #
    def export(self) -> List[Dict[str, Any]]:
        return [sp.export() for sp in self.spans]

    def drain_export(self) -> List[Dict[str, Any]]:
        """Export and clear the buffer (the wire piggyback path)."""
        out = self.export()
        self.spans = []
        return out

    def ingest(self, summaries: List[Dict[str, Any]]) -> None:
        """Fold spans exported by another tracer (usually another
        process) into this buffer."""
        for d in summaries:
            if len(self.spans) < self.capacity:
                self.spans.append(Span.from_export(d))
            else:
                self.dropped += 1

    def clear(self) -> None:
        self.spans = []
        self.dropped = 0


class _NullCM:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: object) -> bool:
        return False


_NULL_CM = _NullCM()


class NullTracer(Tracer):
    enabled = False

    def __init__(self) -> None:
        super().__init__("null", capacity=0)

    def span(self, name: str, **attrs: Any):  # type: ignore[override]
        return _NULL_CM

    def adopt(self, ctx: Dict[str, int]):  # type: ignore[override]
        return _NULL_CM

    def context(self) -> Optional[Dict[str, int]]:
        return None


NULL_TRACER = NullTracer()
