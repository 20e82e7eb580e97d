"""SampledCoreDBSCAN — the DBSCAN++-style sampled-core approximate engine.

The port of ``repro.core.approx``.  Jang & Jiang (2019) show that
running the density test on a uniform sample of the points — and
attaching the rest to the sampled cores — preserves clustering quality
at a fraction of the maintenance cost.  This engine is that idea grafted
onto the SoA exact engine (:class:`~repro_torch.core.soa.SoADynamicDBSCAN`):
every point still enters the bucket directory (membership, occupancy,
attachment scans are unchanged), but **support** — and with it the core
set — is computed over a second per-slot occupancy array ``_ssize``
counting only the *sampled* members.  A point is core iff it is sampled
and one of its buckets holds >= k_s sampled members, where ``k_s =
max(1, round(k * sample_rate))`` is the sampled analogue of the exact
threshold: the expected sampled occupancy of a bucket with k total
members is k * sample_rate, so testing the sampled count against k_s
keeps the density test an unbiased estimate of the exact ">= k total
neighbors" — the same rescaling DBSCAN++ applies to minPts.  Non-sampled
points can only ever be border points, attached to sampled cores through
the existing grab/scan event machinery.

Sampling is a **deterministic hash of the point id** (splitmix64 of
``id`` mixed with ``approx_seed``), not an RNG draw:

  * stable under deletion — removing points never changes who else is
    sampled, so the sampled configuration stays a pure function of the
    live set (the same property that makes the exact engine's support
    history-free);
  * identical across shards, replicas and the two packages — ids are
    global, so every party agrees on the sample with no coordination;
  * nothing to snapshot beyond ``(sample_rate, approx_seed)``, which
    live in the config.

The hash runs in numpy ``uint64`` (wrap-around multiplies, logical
shifts), never in torch, which has no full unsigned 64-bit arithmetic;
the scalar mirror masks Python ints to 64 bits.

At ``sample_rate=1.0`` every mask is all-true, ``_ssize`` coincides
with ``_bsize``, and every hook degenerates to the parent's exact
behavior — the engine is *bit-identical* to the SoA exact engine.

The device path (``use_device``) runs an insert batch's stats as one
pass of :class:`~repro_torch.core.soa.DeviceInsertPass` with two
mirrored tables: one upload of the slots and the sample mask, one launch
of ``bucket_insert_pass``'s masked route (every row into ``_bsize``, the
sampled rows into ``_ssize``, every row's support against the new
``_ssize`` at ``core_k``), one download.  The reference makes three
kernel calls there.  Every host change of the tables outside that pass
marks both mirrors stale (``_sizes_changed``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from .hashing import GridLSH
from .soa import _EMPTY_MEMBERS, DeviceInsertPass, SoADynamicDBSCAN

_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB


def sampled_mask(ids: Sequence[int], rate: float, seed: int) -> np.ndarray:
    """(n,) bool: which of ``ids`` are in the deterministic sample.

    splitmix64 of ``id + seed·golden``; a point is sampled when the top
    53 bits of the hash, read as a uniform in [0, 1), fall below
    ``rate``.  Pure function of ``(id, rate, seed)`` — the single source
    of truth every consumer (engine, adapter, tests) shares.
    """
    ids_a = np.asarray(list(ids), dtype=np.int64).astype(np.uint64)
    if rate >= 1.0:
        return np.ones(len(ids_a), dtype=bool)
    z = ids_a + np.uint64((seed * _GOLDEN + _GOLDEN) & _M64)
    z ^= z >> np.uint64(30)
    z = z * np.uint64(_MIX1)
    z ^= z >> np.uint64(27)
    z = z * np.uint64(_MIX2)
    z ^= z >> np.uint64(31)
    thresh = np.uint64(int(rate * (1 << 53)))
    return (z >> np.uint64(11)) < thresh


def is_sampled(idx: int, rate: float, seed: int) -> bool:
    """Scalar mirror of :func:`sampled_mask` (bit-identical)."""
    if rate >= 1.0:
        return True
    z = (int(idx) + seed * _GOLDEN) & _M64
    z = (z + _GOLDEN) & _M64
    z ^= z >> 30
    z = (z * _MIX1) & _M64
    z ^= z >> 27
    z = (z * _MIX2) & _M64
    z ^= z >> 31
    return (z >> 11) < int(rate * (1 << 53))


class SampledCoreDBSCAN(SoADynamicDBSCAN):
    """Sampled-core approximate dynamic DBSCAN over the SoA layout."""

    def __init__(self, d: int, k: int, t: int, eps: float, seed: int = 0,
                 use_device: bool = False, attach_orphans: bool = True,
                 lsh: Optional[GridLSH] = None, repair: str = "exact",
                 sample_rate: float = 1.0, approx_seed: int = 0,
                 device: str = "cuda"):
        if not 0.0 < sample_rate <= 1.0:
            raise ValueError(
                f"sample_rate must be in (0, 1], got {sample_rate}")
        self.sample_rate = float(sample_rate)
        self.approx_seed = int(approx_seed)
        super().__init__(d, k, t, eps, seed=seed, use_device=use_device,
                         attach_orphans=attach_orphans, lsh=lsh,
                         repair=repair, device=device)
        # sampled-analogue support threshold (degenerates to k at 1.0,
        # keeping the rate=1.0 oracle bit-identical to the exact engine)
        self.core_k = max(1, int(round(self.k * self.sample_rate)))
        # sampled occupancy per slot — the sizes support runs on; grown
        # in lockstep with _bsize by _ensure_slots
        self._ssize = np.zeros(len(self._bsize), np.int32)
        # sampled members per slot, maintained alongside _members: the
        # core-candidate pool crossings/demotions/scans/re-links walk.
        # Without it every deleted core's border re-links would rescan
        # full buckets that are mostly non-sampled.
        self._smembers: Dict[int, Set[int]] = {}
        if self.use_device:
            # the stats pass mirrors both tables: _bsize and _ssize
            self._dpass = DeviceInsertPass(self.device, core_table=True)

    # ------------------------------------------------------------------ #
    # sampling hooks (see SoADynamicDBSCAN; all-true masks at rate=1.0
    # make every one of these the parent's exact behavior)
    # ------------------------------------------------------------------ #
    def _elig_mask(self, ids: Sequence[int]) -> Optional[np.ndarray]:
        return sampled_mask(ids, self.sample_rate, self.approx_seed)

    def _core_candidate(self, m: int) -> bool:
        return is_sampled(m, self.sample_rate, self.approx_seed)

    def _grab_skip(self, s: int) -> bool:
        # skip only when every member is a final core: all sampled
        # members core (_ssize >= k_s) and no non-sampled members at all
        return (self._ssize[s] >= self.core_k
                and self._bsize[s] == self._ssize[s])

    def _core_sizes(self, ns: int) -> np.ndarray:
        return self._ssize[:ns]

    def _core_members(self, s: int) -> Set[int]:
        return self._smembers.get(s) or _EMPTY_MEMBERS

    def _member_discard(self, s: int, idx: int) -> None:
        # the full _members sets are never populated here (see
        # _add_members), so only the sampled view needs updating
        if self._core_candidate(idx):
            sm = self._smembers.get(s)
            if sm is not None:
                sm.discard(idx)

    def _add_members(self, slots: np.ndarray, out: List[int]) -> None:
        # Deliberately does NOT call super(): every hot-path consumer of
        # bucket membership goes through _core_members, and occupancy /
        # emptiness tests read _bsize, so the engine never needs the
        # full per-slot member sets — maintaining them for the ~9/10
        # non-sampled points would cost more than the entire sampled
        # bookkeeping.  _members entries stay as the empty sets
        # _alloc_slot seeds.  Each set is filled in stable-argsort order,
        # the reference's: its iteration order is part of the result.
        m = sampled_mask(out, self.sample_rate, self.approx_seed)
        sub = np.nonzero(m)[0]
        if not len(sub):
            return
        ids_s = [out[j] for j in sub]
        for i in range(self.t):
            col = slots[sub, i]
            order = np.argsort(col, kind="stable")
            sorted_ids = [ids_s[j] for j in order]
            cs = col[order]
            bounds = np.nonzero(cs[1:] != cs[:-1])[0] + 1
            lo = 0
            for hi in list(bounds) + [len(cs)]:
                self._smembers.setdefault(int(cs[lo]), set()).update(
                    sorted_ids[lo:hi])
                lo = hi

    def _free_slot(self, s: int) -> None:
        super()._free_slot(s)
        self._smembers.pop(s, None)

    def _ensure_slots(self, need: int) -> None:
        super()._ensure_slots(need)
        if len(self._ssize) < len(self._bsize):
            self._ssize = np.concatenate([
                self._ssize,
                np.zeros(len(self._bsize) - len(self._ssize), np.int32)])

    def _batch_stats(self, slots: np.ndarray, flat: np.ndarray, ns: int,
                     smask: Optional[np.ndarray]):
        """Full occupancy drives membership; sampled occupancy drives
        support.  On the device path one two-table pass (one launch of
        the masked ``bucket_insert_pass``) updates ``_bsize[:ns]`` and
        ``_ssize[:ns]`` in place from its download."""
        if self.use_device:
            delta, sdelta, supp = self._dpass.run(
                slots, self._bsize[:ns], self.core_k,
                host_core_sizes=self._ssize[:ns], row_mask=smask)
        else:
            rows_s = np.nonzero(smask)[0]
            delta = np.bincount(flat, minlength=ns).astype(np.int32)
            self._bsize[:ns] += delta
            sdelta = np.bincount(
                slots[rows_s].ravel(), minlength=ns).astype(np.int32)
            self._ssize[:ns] += sdelta
            supp = np.add.reduce(
                self._ssize[slots] >= self.core_k, axis=1, dtype=np.int32)
        supp = np.where(smask, supp, 0).astype(np.int32)
        core_new = self._ssize[:ns]
        return core_new - sdelta, core_new, self._ssize[slots], supp

    def _bucket_shrink(self, s: int, idx: int) -> bool:
        # does not call super(), so it marks the mirrors stale itself
        self._bsize[s] -= 1
        self._sizes_changed()
        if not self._core_candidate(idx):
            return False
        self._ssize[s] -= 1
        return self._ssize[s] == self.core_k - 1

    def _apply_occupancy_delta(self, dep: np.ndarray, core_dep: np.ndarray,
                               ns: int) -> None:
        super()._apply_occupancy_delta(dep, core_dep, ns)  # marks stale
        self._ssize[:ns] -= core_dep

    def _rebuild_support(self, slots: np.ndarray,
                         ids: List[int]) -> np.ndarray:
        m = sampled_mask(ids, self.sample_rate, self.approx_seed)
        ns = self._n_slots
        self._ssize[:ns] = np.bincount(
            slots[m].ravel(), minlength=ns).astype(np.int32)
        self._sizes_changed()
        supp = np.add.reduce(self._ssize[slots] >= self.core_k, axis=1)
        return np.where(m, supp, 0)

    # ------------------------------------------------------------------ #
    # diagnostics
    # ------------------------------------------------------------------ #
    def n_sampled(self) -> int:
        """Live sampled points (the core-candidate population)."""
        if not self._row:
            return 0
        return int(sampled_mask(list(self._row), self.sample_rate,
                                self.approx_seed).sum())

    def _check_device_mirrors(self) -> None:
        self._dpass.check(self._bsize, self._n_slots, self._ssize)
        self._hpass.check(self._dir)

    def _check_counts(self, rows: np.ndarray, ids: np.ndarray,
                      core_ids: Set[int]) -> None:
        m = sampled_mask(ids, self.sample_rate, self.approx_seed)
        slots = self._slots[rows]
        # 1. occupancy totals: full sizes count every live (point, table)
        #    pair; sampled sizes and the sampled member sets agree and
        #    carry only sampled live points.  (No full per-slot member
        #    sets exist to compare _bsize against — see _add_members.)
        live_slots = np.nonzero(self._bsize[:self._n_slots] > 0)[0]
        assert int(self._bsize[live_slots].sum()) == self.t * len(rows)
        sampled_live = {int(i) for i, smp in zip(ids, m) if smp}
        for s, sm in self._smembers.items():
            assert self._ssize[s] == len(sm), (s, self._ssize[s], len(sm))
            assert sm <= sampled_live, s
            # 2. buckets with >= k_s sampled members: sampled members core
            if len(sm) >= self.core_k:
                assert all(y in core_ids for y in sm)
        assert int(self._ssize[:self._n_slots].sum()) == sum(
            len(v) for v in self._smembers.values())
        assert int(self._ssize[:self._n_slots].sum()) == self.t * len(
            sampled_live)
        supp = np.where(m, np.add.reduce(self._ssize[slots] >= self.core_k,
                                         axis=1), 0)
        assert np.array_equal(supp, self._support[rows])
        # non-sampled points never hold support
        assert not np.any(self._support[rows][~m])
