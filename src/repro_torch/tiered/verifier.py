"""The verifier thread: async exact application + tier divergence diffs.

One daemon thread per :class:`~repro_torch.tiered.TieredIndex`.  It
drains the bounded mutation queue, applies each batch to the exact back
tier under the back lock, and every ``diff_every`` applied batches (and
on every ``flush()`` barrier) runs a divergence round:

  1. canonical labellings of both tiers over their common live set;
  2. ARI between them -> the ``tiered.divergence_ari`` gauge;
  3. per-point disagreement: inside each front cluster the majority
     (front, back) pairing is the expected mapping — points off the
     majority are *diverged*, and their table-0 buckets are marked hot
     in the :class:`~repro_torch.tiered.DivergencePolicy`.

The queue being bounded is the backpressure contract: when the exact
tier falls more than ``queue_max`` batches behind, mutations block
instead of growing an unbounded apply backlog.
"""

from __future__ import annotations

import queue
import threading
from typing import TYPE_CHECKING, Dict, List, Tuple

from ..core.dynamic_dbscan import NOISE
from ..core.metrics import adjusted_rand_index

if TYPE_CHECKING:  # pragma: no cover
    from .index import TieredIndex

#: queue items: ("insert", X, ids) | ("delete", ids, None) |
#: ("sync", Event, None) — the barrier flush() waits on
_SYNC = "sync"


class Verifier(threading.Thread):
    def __init__(self, index: "TieredIndex", queue_max: int = 64,
                 diff_every: int = 4):
        super().__init__(name="tiered-verifier", daemon=True)
        if queue_max < 1:
            raise ValueError(f"queue_max must be >= 1, got {queue_max}")
        self.index = index
        self.ops: "queue.Queue" = queue.Queue(maxsize=queue_max)
        self.diff_every = max(1, int(diff_every))
        self.round_no = 0
        self.n_applied_batches = 0
        self.n_diff_rounds = 0
        self.last_ari = 1.0
        self._since_diff = 0
        self._stopping = threading.Event()
        self._crash: List[BaseException] = []

    # ------------------------------------------------------------------ #
    # producer side (called by TieredIndex under its mutation lock)
    # ------------------------------------------------------------------ #
    def submit(self, op: Tuple) -> None:
        while True:
            self._reraise()
            try:
                self.ops.put(op, timeout=1.0)
                return
            except queue.Full:
                if not self.is_alive():
                    raise RuntimeError(
                        "tiered verifier is not running") from None

    def flush(self) -> None:
        """Barrier: every op submitted before this call is applied to the
        back tier, and a divergence round has run on the drained state."""
        done = threading.Event()
        self.submit((_SYNC, done, None))
        while not done.wait(timeout=1.0):
            self._reraise()
            if not self.is_alive():
                raise RuntimeError("tiered verifier is not running")
        self._reraise()

    def stop(self) -> None:
        self._stopping.set()
        try:  # wake a drain blocked on an empty queue; a full queue means
            # the thread is mid-apply and will see the stop flag itself
            self.ops.put_nowait((_SYNC, threading.Event(), None))
        except queue.Full:
            pass
        self.join(timeout=30.0)

    def _reraise(self) -> None:
        if self._crash:
            raise RuntimeError("tiered verifier died") from self._crash[0]

    # ------------------------------------------------------------------ #
    # consumer side
    # ------------------------------------------------------------------ #
    def run(self) -> None:  # pragma: no branch
        idx = self.index
        while not self._stopping.is_set():
            op = self.ops.get()
            try:
                kind = op[0]
                if kind == _SYNC:
                    # drain everything already queued, then diff, so the
                    # barrier leaves the tiers comparable
                    self._drain_ready()
                    if not self._stopping.is_set():
                        self._diff()
                    op[1].set()
                else:
                    self._apply(op)
                    self._since_diff += 1
                    if self._since_diff >= self.diff_every:
                        self._diff()
            except BaseException as exc:  # noqa: BLE001 — surfaced to callers
                self._crash.append(exc)
                if kind == _SYNC:
                    op[1].set()
                return
            finally:
                idx.gauge_depth.set(self.ops.qsize())

    def _drain_ready(self) -> None:
        while True:
            try:
                op = self.ops.get_nowait()
            except queue.Empty:
                return
            if op[0] == _SYNC:
                op[1].set()
                continue
            self._apply(op)

    def _apply(self, op: Tuple) -> None:
        idx = self.index
        kind, payload, ids = op
        with idx._back_lock:
            if kind == "insert":
                idx.back.insert_batch(payload, ids=ids)
            elif kind == "delete":
                idx.back.delete_batch(payload)
            else:  # pragma: no cover - queue discipline
                raise ValueError(f"unknown tiered op {kind!r}")
        n = len(ids) if kind == "insert" else len(payload)
        with idx._lag_lock:
            idx._lag -= n
            idx.gauge_lag.set(idx._lag)
        self.n_applied_batches += 1

    # ------------------------------------------------------------------ #
    def _diff(self) -> None:
        idx = self.index
        self.round_no += 1
        self.n_diff_rounds += 1
        self._since_diff = 0
        with idx._lock:
            front = idx.front.labels()
        with idx._back_lock:
            back = idx.back.labels()
        common = sorted(set(front) & set(back))
        if not common:
            ari = 1.0
        else:
            ari = adjusted_rand_index([front[i] for i in common],
                                      [back[i] for i in common])
        self.last_ari = ari
        idx.gauge_ari.set(ari)
        idx.policy.sweep(self.round_no)
        if ari >= 1.0 or not common:
            return
        # majority (front -> back) pairing per front cluster; off-majority
        # points are the diverged set
        votes: Dict[int, Dict[int, int]] = {}
        for i in common:
            c = votes.setdefault(front[i], {})
            c[back[i]] = c.get(back[i], 0) + 1
        best = {fl: max(c.items(), key=lambda kv: (kv[1], kv[0]))[0]
                for fl, c in votes.items()}
        diverged = [i for i in common
                    if back[i] != best[front[i]]
                    and not (front[i] == NOISE and back[i] == NOISE)]
        if diverged:
            with idx._lock:
                keys = [idx._key0(i) for i in diverged if i in idx._pts]
            idx.policy.mark(keys, self.round_no)
            idx.gauge_hot.set(len(idx.policy))
