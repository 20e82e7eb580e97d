"""Reading ``torch.profiler``'s trace of a run of steps: the device's busy
time, its operations by name, and its idle gaps by what the host was
doing (the harness's ``pb.*`` ranges around the calls into the program).

Busy time is the union of the device's kernel, copy and set intervals
(annotations mirrored onto the device's timeline are left out) within
the traced window, which runs from the start of the first ``pb.*`` range
to the end of the last.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

PREFIX = "pb."
NAME_CHARS = 64


def label(name: str):
    return record_function(PREFIX + name)


def start():
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    kernels: Dict[str, Tuple[int, float]]
    read_s: float

    def kernel(self, part: str) -> Tuple[int, float]:
        """(launches, device seconds) of the device operations whose name
        holds ``part``."""
        n, s = 0, 0.0
        for name, (c, sec) in self.kernels.items():
            if part in name:
                n, s = n + c, s + sec
        return n, s


def _is_device_op(e) -> bool:
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    if e.name().startswith(PREFIX):
        return False
    annotation = getattr(e, "is_user_annotation", None)
    return not (annotation is not None and annotation())


def stop(prof) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()


def summarize(prof) -> TraceSummary:
    """The stopped profiler's trace, read."""
    t0 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    host, dev = [], []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if e.name().startswith(PREFIX):
                host.append((e.start_ns(), e.end_ns(),
                             e.name()[len(PREFIX):]))
        elif _is_device_op(e):
            dev.append((e.start_ns(), e.end_ns(), e.name()))
    if not host:
        raise RuntimeError("the profiler recorded none of the harness's "
                           "ranges")
    w0 = min(a for a, _, _ in host)
    w1 = max(b for _, b, _ in host)
    kernels: Dict[str, Tuple[int, float]] = {}
    spans = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        c, s = kernels.get(name, (0, 0.0))
        kernels[name] = (c + 1, s + (b - a) / 1e9)
        spans.append((a, b))
    spans.sort()
    busy = 0
    gaps = []
    cur = w0
    for a, b in spans:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if cur < w1:
        gaps.append((cur, w1))
    host.sort()
    by_label: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        what = next((n for s, e, n in host if s <= mid <= e), "other")
        by_label[what] = by_label.get(what, 0.0) + (b - a) / 1e9
    by_op: Dict[str, float] = {}
    for name, (_, s) in kernels.items():
        short = name[:NAME_CHARS]
        by_op[short] = by_op.get(short, 0.0) + s
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_label.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                        device_ops=[[k, v] for k, v in top],
                        idle_gaps=[[k, v] for k, v in idle],
                        kernels=kernels, read_s=time.perf_counter() - t0)
