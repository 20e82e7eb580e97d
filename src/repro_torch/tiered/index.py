"""``TieredIndex`` — the approx-serves / exact-verifies ClusterIndex.

The port of ``repro.tiered.index``, host code: both tiers are host
backends (``approx``, ``soa``), so no kernel launches here.

Construction: ``build_index(ClusterConfig(backend="tiered",
sample_rate=0.2, ...))``.  One config fans into both tiers — the front
is ``backend="approx"`` at the config's ``sample_rate``, the back is the
exact SoA engine (``sample_rate=1.0``) — so tier labels are directly
comparable (same LSH family, same k/t/eps) and snapshots nest both
states under one config.

Locking discipline (the reason there are three locks):

  * ``_mut_lock`` (outer) serialises mutators across *front apply +
    queue submit*, so the queue order is exactly the front apply order;
  * ``_lock`` (inner) guards the front tier and the point store; it is
    **released before the queue put**, so a mutator blocked on a full
    queue (backpressure) never holds the lock the verifier's divergence
    diff needs — no producer/consumer deadlock cycle;
  * ``_back_lock`` guards the back tier (verifier applies, escalated
    queries read).

``label()`` serves from the front tier; when the point's table-0 bucket
was recently diverged (see :mod:`repro_torch.tiered.policy`) and the
point has already reached the back tier, the query escalates to the
exact answer.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..api.config import ClusterConfig
from ..api.index import ClusterIndex
from ..api.registry import build_index
from ..core.hashing import GridLSH
from .policy import DivergencePolicy
from .verifier import Verifier


class TieredIndex(ClusterIndex):
    native_component_queries = True

    def __init__(self, cfg: ClusterConfig, queue_max: int = 64,
                 diff_every: int = 4, ttl_rounds: int = 3):
        super().__init__(cfg)
        self.front = build_index(cfg.replace(backend="approx", obs=False))
        self.back = build_index(cfg.replace(backend="soa", sample_rate=1.0,
                                            obs=False))
        # host-key LSH for the policy's bucket granularity only — it need
        # not match the engines' mixed keys, just be stable per point
        self.lsh = GridLSH(cfg.d, cfg.eps, cfg.t, seed=cfg.seed)
        self._pts: Dict[int, np.ndarray] = {}
        self._mut_lock = threading.Lock()
        self._lock = threading.RLock()
        self._back_lock = threading.RLock()
        self._lag_lock = threading.Lock()
        self._lag = 0  # points applied to front, not yet to back
        self.n_escalations = 0
        self.gauge_lag = self.obs.gauge("tiered.lag")
        self.gauge_depth = self.obs.gauge("tiered.queue_depth")
        self.gauge_ari = self.obs.gauge("tiered.divergence_ari")
        self.gauge_hot = self.obs.gauge("tiered.hot_buckets")
        self._c_esc = self.obs.counter("tiered.escalations")
        self.gauge_ari.set(1.0)
        self.policy = DivergencePolicy(ttl_rounds=ttl_rounds)
        self.verifier = Verifier(self, queue_max=queue_max,
                                 diff_every=diff_every)
        self._closed = False
        self.verifier.start()

    # ------------------------------------------------------------------ #
    # mutations: front synchronously, back via the verifier queue
    # ------------------------------------------------------------------ #
    def _key0(self, idx: int) -> bytes:
        return self.lsh.keys(self._pts[idx])[0]

    def _submit(self, op: Tuple, n: int) -> None:
        with self._lag_lock:
            self._lag += n
            self.gauge_lag.set(self._lag)
        self.verifier.submit(op)

    def insert(self, x: np.ndarray, idx: Optional[int] = None) -> int:
        return self.insert_batch(np.asarray(x, dtype=np.float64)[None],
                                 ids=[idx])[0]

    def insert_batch(self, X: np.ndarray,
                     ids: Optional[Sequence[Optional[int]]] = None
                     ) -> List[int]:
        X = np.asarray(X, dtype=np.float64)
        with self._mut_lock:
            with self._lock:
                out = self.front.insert_batch(X, ids=ids)
                for j, i in enumerate(out):
                    self._pts[i] = X[j]
            self._submit(("insert", X, out), len(out))
        return out

    def delete(self, idx: int) -> None:
        self.delete_batch([idx])

    def delete_batch(self, ids: Sequence[int]) -> None:
        ids = [int(i) for i in ids]
        with self._mut_lock:
            with self._lock:
                self.front.delete_batch(ids)  # raises before any removal
                for i in ids:
                    del self._pts[i]
            self._submit(("delete", ids, None), len(ids))

    def flush(self) -> None:
        """Barrier: back tier catches up and a divergence round runs."""
        self.verifier.flush()

    # ------------------------------------------------------------------ #
    # queries: front tier, escalated on recent divergence
    # ------------------------------------------------------------------ #
    def label(self, idx: int) -> int:
        with self._lock:
            if idx not in self.front:
                raise KeyError(idx)
            escalate = self.policy.hot(self._key0(idx),
                                       self.verifier.round_no)
            if not escalate:
                return self.front.label(idx)
        with self._back_lock:
            if idx in self.back:
                self.n_escalations += 1
                self._c_esc.inc()
                return self.back.label(idx)
        # not yet verified: the approx answer is all there is
        with self._lock:
            return self.front.label(idx)

    def labels(self, ids: Optional[Iterable[int]] = None) -> Dict[int, int]:
        with self._lock:
            return self.front.labels(ids)

    def exact_labels(self,
                     ids: Optional[Iterable[int]] = None) -> Dict[int, int]:
        """The back tier's labelling after a catch-up barrier."""
        self.flush()
        with self._back_lock:
            return self.back.labels(ids)

    def component_of(self, idx: int) -> int:
        with self._lock:
            return self.front.component_of(idx)

    def core_anchor_of(self, idx: int) -> Optional[int]:
        with self._lock:
            return self.front.core_anchor_of(idx)

    def is_core(self, idx: int) -> bool:
        with self._lock:
            return self.front.is_core(idx)

    def drain_deltas(self):
        with self._lock:
            return self.front.drain_deltas()

    def ids(self) -> List[int]:
        with self._lock:
            return self.front.ids()

    def __contains__(self, idx: int) -> bool:
        with self._lock:
            return idx in self.front

    def __len__(self) -> int:
        with self._lock:
            return len(self.front)

    # ------------------------------------------------------------------ #
    # persistence: both tiers nested under one snapshot (flattened with
    # prefixed keys, like the sharded index's shard<i>/ convention)
    # ------------------------------------------------------------------ #
    def _state(self) -> Dict[str, np.ndarray]:
        self.flush()
        with self._lock, self._back_lock:
            out = {f"front/{k}": v for k, v in self.front._state().items()}
            out.update(
                {f"back/{k}": v for k, v in self.back._state().items()})
            return out

    def _load_state(self, state: Dict[str, np.ndarray]) -> None:
        front = {k[len("front/"):]: v for k, v in state.items()
                 if k.startswith("front/")}
        back = {k[len("back/"):]: v for k, v in state.items()
                if k.startswith("back/")}
        with self._lock, self._back_lock:
            self.front._load_state(front)
            self.back._load_state(back)
            eng = self.front.engine
            for i, r in eng._row.items():
                self._pts[i] = np.array(eng._pts[r], dtype=np.float64)

    def snapshot(self) -> Dict[str, Any]:
        self.flush()
        return super().snapshot()

    def restore(self, snapshot: Dict[str, Any]) -> None:
        super().restore(snapshot)
        self.flush()

    # ------------------------------------------------------------------ #
    # lifecycle / diagnostics
    # ------------------------------------------------------------------ #
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.verifier.stop()
        self.front.close()
        self.back.close()

    def check_invariants(self) -> None:
        self.flush()
        with self._lock, self._back_lock:
            self.front.check_invariants()
            self.back.check_invariants()
            f, b = set(self.front.ids()), set(self.back.ids())
            assert f == b, ("tier id sets diverged after flush",
                            f ^ b)
            assert f == set(self._pts), "point store out of sync"

    def stats(self) -> Dict[str, Any]:
        with self._lag_lock:
            lag = self._lag
        return {
            "lag": lag,
            "queue_depth": self.verifier.ops.qsize(),
            "divergence_ari": self.verifier.last_ari,
            "diff_rounds": self.verifier.n_diff_rounds,
            "applied_batches": self.verifier.n_applied_batches,
            "escalations": self.n_escalations,
            "hot_buckets": len(self.policy),
            "front": self.front.stats(),
            "back": self.back.stats(),
        }
