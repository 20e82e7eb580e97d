"""The program's spans (``repro_torch.obs``) joined with the profiler's
trace of the same steps: device time by the phase that launched it, and
the device's idle time under curation.

Both sides are on one clock: the profiler's events carry epoch
nanoseconds, and so does each span's ``start_ns`` / ``end_ns``.  A
device operation is charged to the phase whose span was open, on the
thread that launched it, when it was launched: the time of the CUDA
runtime call with the operation's correlation id, not the time it ran.

- ``train.forward``, ``train.backward``, ``train.optimizer`` give their
  phase, and anything inside a ``curation.*`` span gives ``curation``;
  a launch on a thread in no such span is ``other``.
- A thread with no spans of its own (the autograd engine's, which runs
  the backward while the trainer's thread holds ``train.backward``
  open) is charged by the spans of the thread that holds ``train.step``.
- A device operation whose launch the trace does not hold is ``other``,
  and counted.

The profiler names a thread it registered (the one that started it, the
autograd engine's) by its OS id, and any other thread by the low 32 bits
of its ``pthread_self()`` as a signed number; :func:`thread_aliases`
maps the latter back to the OS ids that the spans record.

Pure functions over lists; :func:`from_profiler` reads a stopped
``torch.profiler`` into them.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PHASES = ("forward", "backward", "optimizer", "curation", "other")
_PHASE_OF = {"train.forward": "forward", "train.backward": "backward",
             "train.optimizer": "optimizer"}
#: names of the CUDA API calls, ``cuda*`` and ``cu*`` (``cudaLaunchKernel``,
#: ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...), not the profiler's own
#: events that share their correlation ids
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")

Op = Tuple[int, int, int]          # device op: start_ns, end_ns, correlation
Launch = Tuple[int, int]           # runtime call: start_ns, thread id


@dataclasses.dataclass
class Phases:
    """Device seconds charged to each of :data:`PHASES`, the device
    operations whose launch was not found, and the ``train.step`` spans
    begun in the window."""
    device_s: Dict[str, float]
    unmatched: int
    steps: int


def thread_aliases(threads: Iterable) -> Dict[int, int]:
    """``{profiler's id: OS id}`` for ``threading.Thread`` objects that
    the profiler did not register: the low 32 bits of ``t.ident`` (the
    thread's ``pthread_self()``), which the profiler gives as a signed
    number."""
    out = {}
    for t in threads:
        if t.ident is not None and t.native_id is not None:
            low = t.ident & 0xFFFFFFFF
            out[low - (1 << 32) if low >> 31 else low] = t.native_id
    return out


def from_profiler(prof) -> Tuple[List[Op], Dict[int, Launch],
                                 Tuple[int, int]]:
    """The stopped profiler's device operations, by correlation id the
    runtime calls that launched them, and the traced window (the
    harness's ``pb.*`` ranges, as :func:`.devtrace.summarize` takes
    it)."""
    import torch

    from .devtrace import PREFIX, _is_device_op

    ops, launches, marks = [], {}, []
    cpu = torch.autograd.DeviceType.CPU
    for e in prof.profiler.kineto_results.events():
        if _is_device_op(e):
            ops.append((e.start_ns(), e.end_ns(), e.correlation_id()))
        elif e.device_type() == cpu:
            if e.name().startswith(PREFIX):
                marks += [e.start_ns(), e.end_ns()]
            elif _RUNTIME.match(e.name()):
                launches.setdefault(e.correlation_id(),
                                    (e.start_ns(), e.device_resource_id()))
    return ops, launches, (min(marks, default=0), max(marks, default=0))


def _segments(spans: Sequence) -> List[Tuple[int, int, str]]:
    """One thread's properly nested spans flattened into disjoint
    ``(start, end, phase)`` pieces, each with its innermost span's
    phase (an enclosing span's where the innermost names none)."""
    marks = []
    for sp in spans:
        d = sp.end_ns - sp.start_ns
        # at one time: closes before opens, inner closes and outer opens
        # first
        marks.append(((sp.start_ns, 1, -d), True, sp))
        marks.append(((sp.end_ns, 0, d), False, sp))
    marks.sort(key=lambda m: m[0])
    out: List[Tuple[int, int, str]] = []
    stack: List[str] = []
    t_prev = None
    for (t, _, _), opening, sp in marks:
        if stack and t_prev is not None and t > t_prev:
            out.append((t_prev, t, stack[-1]))
        if opening:
            own = _PHASE_OF.get(sp.name)
            if own is None and sp.name.startswith("curation."):
                own = "curation"
            stack.append(own or (stack[-1] if stack else "other"))
        elif stack:
            stack.pop()
        t_prev = t
    return out


def _clip(a: int, b: int, window: Tuple[int, int]) -> Tuple[int, int]:
    return max(a, window[0]), min(b, window[1])


def phase_device_s(ops: Sequence[Op], launches: Dict[int, Launch],
                   spans: Sequence, window: Tuple[int, int],
                   aliases: Optional[Dict[int, int]] = None) -> Phases:
    """Each device operation's time within ``window`` (epoch ns), charged
    as the module's docstring says."""
    aliases = aliases or {}
    by_tid: Dict[int, list] = {}
    for sp in spans:
        if sp.tid is not None:
            by_tid.setdefault(sp.tid, []).append(sp)
    segs = {tid: _segments(sps) for tid, sps in by_tid.items()}
    starts = {tid: [s[0] for s in ss] for tid, ss in segs.items()}
    trainer = next((sp.tid for sp in spans if sp.name == "train.step"),
                   None)

    def phase(ts: int, tid: int) -> str:
        tid = aliases.get(tid, tid)
        if tid not in segs:
            if trainer is None:
                return "other"
            tid = trainer
        i = bisect.bisect_right(starts[tid], ts) - 1
        if i >= 0 and segs[tid][i][0] <= ts < segs[tid][i][1]:
            return segs[tid][i][2]
        return "other"

    out = dict.fromkeys(PHASES, 0.0)
    unmatched = 0
    for a, b, corr in ops:
        a, b = _clip(a, b, window)
        if b <= a:
            continue
        launch = launches.get(corr)
        if launch is None:
            unmatched += 1
            out["other"] += (b - a) / 1e9
        else:
            out[phase(*launch)] += (b - a) / 1e9
    steps = sum(sp.name == "train.step"
                and window[0] <= sp.start_ns < window[1] for sp in spans)
    return Phases(out, unmatched, steps)


def _union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def idle_under(ops: Sequence[Op], spans: Sequence,
               window: Tuple[int, int],
               name: str = "curation.filter") -> List[Tuple[int, int]]:
    """The intervals within ``window`` in which no device operation ran
    while a span called ``name`` was open."""
    busy = _union(x for x in (_clip(a, b, window) for a, b, _ in ops)
                  if x[1] > x[0])
    idle, cur = [], window[0]
    for a, b in busy:
        if a > cur:
            idle.append((cur, a))
        cur = max(cur, b)
    if cur < window[1]:
        idle.append((cur, window[1]))
    under = _union(x for x in (_clip(sp.start_ns, sp.end_ns, window)
                               for sp in spans if sp.name == name)
                   if x[1] > x[0])
    out = []
    for a, b in idle:
        for c, d in under:
            lo, hi = max(a, c), min(b, d)
            if hi > lo:
                out.append((lo, hi))
    return out


def readings(phases: Optional[Phases], idle: Optional[List[Tuple[int, int]]],
             window: Tuple[int, int], spans: Sequence,
             rebuild: Optional[Tuple[int, Tuple[int, int]]] = None
             ) -> Dict[str, Optional[float]]:
    """The six per-layer numbers the spans and the counter give, each
    None where there is nothing to read (the two device readings without
    a device operation in ``phases``): device ms a traced step of each
    trainer phase; the share of ``window`` idle under curation (%); the
    mean host ms of ``curation.labels`` a ``curation.filter`` call begun
    in ``window``; and ``rebuild = (engine.comp_rebuild_rows's growth,
    (t0, t1) it grew over)`` over the rows of the filter calls whose
    labels pass (where the rebuild runs) began in ``(t0, t1)``."""
    out: Dict[str, Optional[float]] = dict.fromkeys(
        ("forward_device_ms", "backward_device_ms", "optimizer_device_ms",
         "curation_idle_pct", "curation_labels_ms",
         "curation_rebuild_rows_per_point"))
    on_device = phases is not None and any(phases.device_s.values())
    if on_device and phases.steps:
        for p in ("forward", "backward", "optimizer"):
            out[f"{p}_device_ms"] = 1e3 * phases.device_s[p] / phases.steps
    if on_device and idle is not None and window[1] > window[0]:
        out["curation_idle_pct"] = 100.0 * sum(b - a for a, b in idle) \
            / (window[1] - window[0])
    calls = {sp.span_id: sp for sp in spans if sp.name == "curation.filter"}
    labels = [sp for sp in spans
              if sp.name == "curation.labels" and sp.parent_id in calls]
    begun = [sp for sp in labels
             if window[0] <= calls[sp.parent_id].start_ns < window[1]]
    if begun:
        out["curation_labels_ms"] = sum(
            sp.end_ns - sp.start_ns for sp in begun) / 1e6 / len(begun)
    if rebuild is not None:
        grown, (t0, t1) = rebuild
        rows = sum(calls[sp.parent_id].attrs.get("rows", 0) for sp in labels
                   if t0 <= sp.start_ns < t1)
        if rows:
            out["curation_rebuild_rows_per_point"] = grown / rows
    return out
