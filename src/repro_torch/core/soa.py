"""SoADynamicDBSCAN — the vectorised structure-of-arrays engine core.

The port of ``repro.core.soa``: the same host structures and event
replay, with the per-batch array passes (``lsh_hash`` fused with the
directory lookups into ``lsh_hash_resolve``, then ``slot_counts`` and
``bucket_core_stats`` fused into one ``bucket_insert_pass``) run through
:mod:`repro_torch.kernels.ops` on torch tensors on the engine's
``device`` when ``use_device`` is set — the hand-written CUDA kernels on
``"cuda"`` (the default), their plain PyTorch versions on ``"cpu"``.
Each pass keeps a mirror of host state on the device.  The hash pass
(:class:`DeviceHashPass`) mirrors the bucket directory: an insert batch
uploads its points with the directory's pending changes and downloads
the keys with the slots of every key the directory already holds, and
the host looks up only the misses.  The stats pass
(:class:`DeviceInsertPass`) mirrors the bucket sizes: the batch uploads
its slots and downloads the new sizes and support once.  The host
structures stay the source of truth; a change of a directory key reaches
the mirror through ``_dir_changed``, and every host change of the sizes
outside the pass marks that mirror stale (``_sizes_changed``).

Same clustering as ``repro.core.dynamic_dbscan.DynamicDBSCAN``
(Definition 4 cores, Thm-2 component structure, identical border-point
anchoring), different state layout: instead of per-point dicts and
per-bucket Python objects walked point-by-point, the engine keeps

  * a row store of fixed-dtype arrays — ids (i64), points (f64), mixed
    bucket keys (i32 pairs, the ``lsh_hash`` kernel family), bucket
    *slots* (i32), support counts (i32), attach anchors (i64);
  * a bucket directory mapping each table's key bytes to a dense slot id,
    with occupancy in one i32 array and membership in per-slot sets;
  * an epoch-cached connectivity labelling over the *configuration-
    determined* chain edges (see below) instead of an eagerly-maintained
    Euler-tour forest.

``add_batch`` is one vectorised pass per batch — hash kernel with the
directory probes → slot allocation for the misses → occupancy deltas →
support gather → core transitions (the ``repro_torch.kernels`` kernels
on the device path) — with
per-point Python work only for the *events* of the sequential
semantics: threshold crossings, orphan grabs, and border attachment.

Why this is exact, not approximate: support counts, the core set, and the
per-bucket core chains are pure functions of the current point
configuration, and Thm 2 makes core-partition connectivity configuration-
determined too — so they need no incremental history, only the current
arrays.  The *only* history-dependent state is which cluster a border
point anchors to.  The batch path replays the sequential engine's
attachment decisions exactly by event time: a point promoted when bucket
``b`` crosses the threshold at batch step ``s`` grabs unattached orphans
at time ``(s, id)``, a non-core insert at step ``j`` scans its buckets'
cores-at-time-``j`` in table order — the same order `DynamicDBSCAN`
processes ``sorted(promoted)`` and ``_link_non_core_point``.  Transient
states (a point grabbed mid-batch and promoted later the same batch)
cancel out of the final configuration and of the compacted journal, so
they are skipped rather than simulated.

Connectivity is rebuilt per *epoch* (any mutation invalidates, first
query rebuilds): chain edges are consecutive core rows per slot, and the
component labelling is a vectorised Shiloach–Vishkin hook+shortcut pass
(the data-parallel connectivity of Wang et al.'s parallel DBSCAN) — no
scipy dependency, O(E log n) array work, amortised across every label
query in the epoch.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..obs import NULL_OBS
from .dynamic_dbscan import NOISE, check_unique_ids, claim_index
from .hashing import GridLSH

_KEY_W = 8  # mixed keys: 2 int32 words per (point, table)
_EMPTY_MEMBERS: frozenset = frozenset()  # read-only _core_members default


class _LiveView:
    """Membership view over the committed id map plus a batch's staged
    claims — lets ``claim_index`` reject duplicates before any state
    mutation (the batch path is atomic on bad ids, unlike the sequential
    engine's partial prefix)."""

    __slots__ = ("a", "b")

    def __init__(self, a, b):
        self.a, self.b = a, b

    def __contains__(self, idx) -> bool:
        return idx in self.a or idx in self.b


def _sv_components(n_rows: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Shiloach–Vishkin style connectivity: parent pointer per row,
    hook-to-minimum + pointer-jumping until a fixpoint.  Returns the
    fully-compressed parent array (each row points at its component's
    minimum row).  O((E + n) log n) pure array work."""
    parent = np.arange(n_rows, dtype=np.int64)
    if len(a) == 0:
        return parent
    while True:
        pa, pb = parent[a], parent[b]
        lo = np.minimum(pa, pb)
        hi = np.maximum(pa, pb)
        np.minimum.at(parent, hi, lo)
        # shortcut: full pointer-jumping compression
        while True:
            pp = parent[parent]
            if np.array_equal(pp, parent):
                break
            parent = pp
        if np.array_equal(parent[a], parent[b]):
            return parent


class DeviceInsertPass:
    """An insert batch's bucket statistics on a device, against a device
    mirror of a host size table (or of two: ``core_table``).

    The host table stays the source of truth; the mirror follows it
    through the insert passes, and a caller that changes the host table
    any other way calls :meth:`mark_stale`, after which the next pass
    uploads the table again.  A pass is one upload of the batch's slots
    (from pinned memory on ``"cuda"``), one ``ops.bucket_insert_pass``
    launch, which adds the batch's histogram into the mirror and gathers
    the support against the new sizes, and one synchronising download of
    the packed [new sizes | support].  Its buffers persist and grow by
    doubling, so a pass allocates nothing on the device.  On ``"cpu"`` the
    same steps run the plain version on plain tensors (pinned memory needs
    a CUDA build of torch).

    With ``core_table`` (the sampled-core engine) the pass mirrors a
    second table, the sizes the support runs on, and takes the kernel's
    masked route: the row mask is staged beside the slots and goes up in
    the same upload, the launch adds every row into the sizes and the
    masked rows into the core sizes and gathers every row's support
    against the latter, and the download is [new sizes | new core sizes |
    support].  Both mirrors go stale, and are uploaded, together.
    """

    def __init__(self, device: torch.device, core_table: bool = False):
        self.device = device
        self._pinned = device.type == "cuda"
        self.sizes = torch.zeros(256, dtype=torch.int32, device=device)
        self.core_sizes = (torch.zeros(256, dtype=torch.int32, device=device)
                           if core_table else None)
        self.fresh = True  # mirrors == host tables (zero past their end)
        self._in_h = self._in_d = self._out_h = self._out_d = None
        self.n_passes = 0
        self.n_size_uploads = 0  # re-uploads of stale host tables

    def mark_stale(self) -> None:
        self.fresh = False

    def _grow(self, buf: Optional[torch.Tensor], need: int,
              host: bool) -> torch.Tensor:
        if buf is not None and buf.numel() >= need:
            return buf
        cap = 1 << max(10, (need - 1).bit_length())
        if host:
            return torch.empty(cap, dtype=torch.int32,
                               pin_memory=self._pinned)
        return torch.empty(cap, dtype=torch.int32, device=self.device)

    def _mirror(self, table: torch.Tensor, host: np.ndarray,
                upload: bool) -> torch.Tensor:
        """``table`` grown to hold ``len(host)`` entries (zero-extended:
        host slots past a fresh mirror's end are zero), and loaded from
        ``host`` when ``upload``."""
        ns = len(host)
        if ns > table.numel():
            grown = torch.zeros(1 << (ns - 1).bit_length(),
                                dtype=torch.int32, device=self.device)
            grown[:table.numel()].copy_(table)
            table = grown
        if upload:
            table[:ns].copy_(torch.from_numpy(host))
            table[ns:].zero_()
        return table

    def run(self, slots: np.ndarray, host_sizes: np.ndarray, k: int,
            host_core_sizes: Optional[np.ndarray] = None,
            row_mask: Optional[np.ndarray] = None) -> Tuple[np.ndarray, ...]:
        """(B, t) int32 slots and the host table's ``[:ns]`` view ->
        ``(delta (ns,), support (B,))``; ``host_sizes`` is updated in place
        to the new sizes, as the mirror is.  With ``core_table``, also the
        host core table's ``[:ns]`` view and the (B,) bool row mask ->
        ``(delta, core delta (ns,), support)``, both host tables updated
        in place."""
        B, t = slots.shape
        ns = len(host_sizes)
        two = self.core_sizes is not None
        if two != (host_core_sizes is not None and row_mask is not None):
            raise ValueError("a two-table pass takes the core table and "
                             "the row mask; a one-table pass neither")
        upload = not self.fresh
        self.sizes = self._mirror(self.sizes, host_sizes, upload)
        if two:
            self.core_sizes = self._mirror(self.core_sizes,
                                           host_core_sizes, upload)
        if upload:
            self.fresh = True
            self.n_size_uploads += 1
        # staged: the slots, then (two tables) the row mask's bytes
        m = B * t
        mw = -(-B // 4) if two else 0
        head = 2 * ns if two else ns
        no = head + B
        self._in_h = self._grow(self._in_h, m + mw, True)
        self._in_d = self._grow(self._in_d, m + mw, False)
        self._out_h = self._grow(self._out_h, no, True)
        self._out_d = self._grow(self._out_d, no, False)
        staged = self._in_h.numpy()
        staged[:m] = slots.ravel()
        if two:
            staged[m:m + mw].view(np.uint8)[:B] = row_mask
        self._in_d[:m + mw].copy_(self._in_h[:m + mw], non_blocking=True)
        dslots = self._in_d[:m].view(B, t)
        masked = {}
        if two:
            masked = {"core_sizes": self.core_sizes[:ns],
                      "row_mask": self._in_d[m:m + mw].view(
                          torch.uint8)[:B]}
        dout = ops.bucket_insert_pass(dslots, self.sizes[:ns], k=k,
                                      out=self._out_d[:no], **masked)
        self._out_h[:no].copy_(dout, non_blocking=True)
        if self._pinned:
            torch.cuda.current_stream(self.device).synchronize()
        res = self._out_h.numpy()[:no]
        delta = res[:ns] - host_sizes
        host_sizes[:] = res[:ns]
        self.n_passes += 1
        if not two:
            return delta, res[ns:].copy()
        core_delta = res[ns:head] - host_core_sizes
        host_core_sizes[:] = res[ns:head]
        return delta, core_delta, res[head:].copy()

    def check(self, host_table: np.ndarray, ns: int,
              host_core_table: Optional[np.ndarray] = None) -> None:
        """Fresh mirrors equal the host tables' ``[:ns]`` and are zero
        past it (``host_core_table``: the second table, which a two-table
        pass must be given)."""
        if (self.core_sizes is None) != (host_core_table is None):
            raise ValueError("check the mirrors of every table the pass "
                             "holds")
        if not self.fresh:
            return
        pairs = [(self.sizes, host_table)]
        if host_core_table is not None:
            pairs.append((self.core_sizes, host_core_table))
        for table, host in pairs:
            mirror = table.cpu().numpy()
            assert np.array_equal(mirror[:ns], host[:ns])
            assert not mirror[ns:].any()


def directory_cells(entries: Iterable[Tuple[int, bytes, int]]
                    ) -> np.ndarray:
    """(table, 8-byte key, slot) triples -> (m, 4) int32 directory cells
    ``[key a, key b, table, slot]``."""
    entries = list(entries)
    cells = np.empty((len(entries), 4), np.int32)
    if entries:
        cells[:, :2] = np.frombuffer(b"".join(e[1] for e in entries),
                                     np.int32).reshape(-1, 2)
        cells[:, 2] = [e[0] for e in entries]
        cells[:, 3] = [e[2] for e in entries]
    return cells


class DeviceHashPass:
    """An insert batch's keys and their directory slots on a device,
    against a device mirror of a host bucket directory.

    The mirror is an open-addressing table of ``[key a, key b, table,
    slot]`` cells (``ops.lsh_hash_resolve``).  The host directory stays
    the source of truth: each change of one of its keys is recorded
    (:meth:`record`; an insert and an erase of one key before a pass net
    out in one pending map) and applied on the device at the start of the
    next pass; a wholesale change (:meth:`mark_stale`) makes the next pass
    upload the whole directory into an emptied table, and so does growth:
    when live cells plus tombstones could pass half the capacity, the
    table is rebuilt at four times the live count, rounded up to a power
    of two.  A pass is one upload of the points and the pending updates
    (from pinned memory on ``"cuda"``), one launch, which applies the
    updates, hashes the points and probes the table, and one synchronising
    download of the packed [keys | slots].  Its buffers persist and grow
    by doubling, so a pass allocates nothing on the device unless the
    table grows.  On ``"cpu"`` the same steps run the plain version on
    plain tensors (pinned memory needs a CUDA build of torch).
    """

    def __init__(self, device: torch.device, eta: torch.Tensor,
                 mixers: torch.Tensor, inv_cell: float):
        self.device = device
        self._pinned = device.type == "cuda"
        self.eta, self.mixers, self.inv_cell = eta, mixers, inv_cell
        # an empty table; the first rebuild sizes it from the directory
        self.table = torch.full((1024, 4), -1, dtype=torch.int32,
                                device=device)
        self.fresh = True  # mirror + pending == host directory
        self.pending: Dict[Tuple[int, bytes], int] = {}
        self.used = 0  # bound on the table's non-empty cells
        self._in_h = self._in_d = self._out_h = self._out_d = None
        self.n_passes = 0
        self.n_updates = 0   # updates the last pass applied
        self.n_dir_uploads = 0  # whole-directory uploads (stale or growth)
        self.n_dir_growths = 0

    @property
    def cap(self) -> int:
        return self.table.shape[0]

    def record(self, table: int, key: bytes, slot: int) -> None:
        """Host directory change: (table, key) -> slot, -1 for erased."""
        if self.fresh:
            self.pending[(table, key)] = slot

    def mark_stale(self) -> None:
        self.fresh = False
        self.pending.clear()

    def _grow(self, buf: Optional[torch.Tensor], need: int,
              host: bool) -> torch.Tensor:
        if buf is not None and buf.numel() >= need:
            return buf
        cap = 1 << max(10, (need - 1).bit_length())
        if host:
            return torch.empty(cap, dtype=torch.int32,
                               pin_memory=self._pinned)
        return torch.empty(cap, dtype=torch.int32, device=self.device)

    def _updates(self, host_dir: List[Dict[bytes, int]]) -> np.ndarray:
        """The pending updates as cells, or the whole host directory into
        an emptied (and, past half full, grown) table."""
        n_new = sum(s >= 0 for s in self.pending.values())
        if self.fresh and self.used + n_new <= self.cap // 2:
            self.used += n_new
            return directory_cells(
                (i, k, s) for (i, k), s in self.pending.items())
        live = sum(len(t) for t in host_dir)
        cap = max(self.cap, 1 << max(0, (4 * live - 1).bit_length()))
        if cap > self.cap:
            self.table = torch.empty((cap, 4), dtype=torch.int32,
                                     device=self.device)
            self.n_dir_growths += 1
        self.table.fill_(-1)
        self.fresh = True
        self.used = live
        self.n_dir_uploads += 1
        return directory_cells((i, k, s) for i, t in enumerate(host_dir)
                               for k, s in t.items())

    def run(self, X: np.ndarray, host_dir: List[Dict[bytes, int]]
            ) -> Tuple[np.ndarray, np.ndarray]:
        """(B, d) points -> ((B, t, 2) int32 keys, (B, t) int32 slots of
        the keys ``host_dir`` holds, -1 for the others)."""
        B, d = X.shape
        t = self.eta.shape[0]
        upd = self._updates(host_dir)
        self.pending.clear()
        nu = len(upd)
        xw = -(-B * d // 4) * 4  # the updates start 16-byte aligned
        m = B * t
        self._in_h = self._grow(self._in_h, xw + 4 * nu, True)
        self._in_d = self._grow(self._in_d, xw + 4 * nu, False)
        self._out_h = self._grow(self._out_h, 3 * m, True)
        self._out_d = self._grow(self._out_d, 3 * m, False)
        staged = self._in_h.numpy()
        staged[:B * d].view(np.float32).reshape(B, d)[...] = X
        staged[xw:xw + 4 * nu] = upd.ravel()
        dev_in = self._in_d[:xw + 4 * nu]
        dev_in.copy_(self._in_h[:xw + 4 * nu], non_blocking=True)
        dout = ops.lsh_hash_resolve(
            dev_in[:B * d].view(torch.float32).view(B, d), self.eta,
            self.mixers, inv_cell=self.inv_cell, directory=self.table,
            updates=dev_in[xw:].view(nu, 4), out=self._out_d[:3 * m])
        self._out_h[:3 * m].copy_(dout, non_blocking=True)
        if self._pinned:
            torch.cuda.current_stream(self.device).synchronize()
        res = self._out_h.numpy()
        self.n_passes += 1
        self.n_updates = nu
        return (res[:2 * m].reshape(B, t, 2).copy(),
                res[2 * m:3 * m].reshape(B, t).copy())

    def check(self, host_dir: List[Dict[bytes, int]]) -> None:
        """A fresh mirror, with the pending updates applied, holds exactly
        the host directory's (table, key, slot) entries, each once."""
        if not self.fresh:
            return
        cells = self.table.cpu().numpy()
        live = cells[cells[:, 3] >= 0]
        raw = np.ascontiguousarray(live[:, :2]).tobytes()
        mirror = {(int(c[2]), raw[8 * j:8 * j + 8]): int(c[3])
                  for j, c in enumerate(live)}
        assert len(mirror) == len(live), "a key held twice"
        for key, s in self.pending.items():
            if s >= 0:
                mirror[key] = s
            else:
                mirror.pop(key, None)
        assert mirror == {(i, k): s for i, t in enumerate(host_dir)
                          for k, s in t.items()}
        assert self.used >= int((cells[:, 3] != -1).sum())


class SoADynamicDBSCAN:
    """Array-backed exact dynamic DBSCAN (drop-in for the dict engines)."""

    def __init__(self, d: int, k: int, t: int, eps: float, seed: int = 0,
                 use_device: bool = False, attach_orphans: bool = True,
                 lsh: Optional[GridLSH] = None, repair: str = "exact",
                 device: str = "cuda"):
        if repair not in ("exact", "paper"):
            raise ValueError(repair)
        self.d, self.k, self.t, self.eps = d, int(k), int(t), float(eps)
        # the support threshold applied to _core_sizes.  Equal to k here;
        # the sampled-core subclass rescales it to the sampled analogue
        # max(1, round(k * sample_rate)) so the density test stays an
        # unbiased estimate of ">= k total neighbors".
        self.core_k = self.k
        self.lsh = lsh if lsh is not None else GridLSH(d, eps, t, seed)
        if self.lsh.t != self.t or self.lsh.d != d:
            raise ValueError("lsh family incompatible with (d, t)")
        self.use_device = bool(use_device)
        self.attach_orphans = attach_orphans
        # the device the kernel passes run on (unused when use_device is
        # off).  "cuda" needs a card and a kernel library that builds: the
        # engine raises here rather than run anywhere else.
        self.device = torch.device(device)
        if self.use_device:
            if self.device.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        "use_device on 'cuda' but CUDA is not available; "
                        "pass device='cpu' to run the plain kernels")
                ops.ensure_built()
            elif self.device.type != "cpu":
                raise ValueError(f"unsupported device {self.device}")
            self._eta_dev = torch.from_numpy(
                self.lsh.eta.astype(np.float32)).to(self.device)
            self._mix_dev = torch.from_numpy(
                np.ascontiguousarray(self.lsh.mixers)).to(self.device)
            # the insert passes' device mirrors: the support-driving
            # sizes, and the bucket directory the hash pass probes
            self._dpass = DeviceInsertPass(self.device)
            self._hpass = DeviceHashPass(self.device, self._eta_dev,
                                         self._mix_dev, self.lsh.inv_cell)

        cap = 256
        self._cap = cap
        self._top = 0                      # high-water row
        self._ids = np.full(cap, -1, np.int64)
        self._pts = np.zeros((cap, d), np.float64)
        self._keys32 = np.zeros((cap, t, 2), np.int32)
        self._slots = np.zeros((cap, t), np.int32)
        self._support = np.zeros(cap, np.int32)
        self._attach = np.full(cap, -1, np.int64)
        self._row: Dict[int, int] = {}     # id -> row (insertion-ordered)
        self._free_rows: List[int] = []

        # bucket directory: per-table key-bytes -> dense slot id
        self._dir: List[Dict[bytes, int]] = [dict() for _ in range(t)]
        self._slot_key: List[Optional[Tuple[int, bytes]]] = []
        self._bsize = np.zeros(256, np.int32)  # capacity-doubling
        self._n_slots = 0
        self._members: Dict[int, Set[int]] = {}
        self._free_slots: List[int] = []

        self.anchored: Dict[int, Set[int]] = {}
        self._next_idx = 0
        self._journal: Optional[
            List[Tuple[int, Optional[int], Optional[int]]]] = None
        # epoch cache: row -> component handle for core rows (None = dirty)
        self._comp: Optional[np.ndarray] = None

        # instrumentation (adapter stats())
        self.n_epoch_rebuilds = 0
        self.n_promotions = 0
        self.n_demotions = 0
        self.n_grab_events = 0
        self.n_scan_events = 0
        self.obs = NULL_OBS

    # ------------------------------------------------------------------ #
    # capacity management
    # ------------------------------------------------------------------ #
    def _ensure_rows(self, need: int) -> None:
        if need <= self._cap:
            return
        cap = self._cap
        while cap < need:
            cap *= 2
        grow = cap - self._cap
        self._ids = np.concatenate([self._ids, np.full(grow, -1, np.int64)])
        self._pts = np.concatenate(
            [self._pts, np.zeros((grow, self.d), np.float64)])
        self._keys32 = np.concatenate(
            [self._keys32, np.zeros((grow, self.t, 2), np.int32)])
        self._slots = np.concatenate(
            [self._slots, np.zeros((grow, self.t), np.int32)])
        self._support = np.concatenate(
            [self._support, np.zeros(grow, np.int32)])
        self._attach = np.concatenate(
            [self._attach, np.full(grow, -1, np.int64)])
        self._cap = cap

    def _ensure_slots(self, need: int) -> None:
        if need <= len(self._bsize):
            return
        cap = len(self._bsize)
        while cap < need:
            cap *= 2
        self._bsize = np.concatenate(
            [self._bsize, np.zeros(cap - len(self._bsize), np.int32)])

    def _alloc_slot(self, table: int, key: bytes) -> int:
        if self._free_slots:
            s = self._free_slots.pop()
            self._slot_key[s] = (table, key)
        else:
            s = self._n_slots
            self._slot_key.append((table, key))
            self._n_slots += 1
        self._dir[table][key] = s
        self._dir_changed(table, key, s)
        self._members[s] = set()
        return s

    def _free_slot(self, s: int) -> None:
        table, key = self._slot_key[s]  # type: ignore[misc]
        del self._dir[table][key]
        self._dir_changed(table, key, -1)
        self._slot_key[s] = None
        self._members.pop(s, None)
        self._free_slots.append(s)

    def _dir_changed(self, table: Optional[int] = None, key: bytes = b"",
                     slot: int = -1) -> None:
        """The host directory changed: ``(table, key)`` now maps to
        ``slot`` (-1: erased), or, with no table, all of it did.  The
        device mirror takes a key's change at the start of the next hash
        pass; after a wholesale change that pass uploads the directory."""
        if not self.use_device:
            return
        if table is None:
            self._hpass.mark_stale()
        else:
            self._hpass.record(table, key, slot)

    # ------------------------------------------------------------------ #
    # hashing / slot resolution
    # ------------------------------------------------------------------ #
    def _hash_batch(self, X: np.ndarray
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(B, d) -> ((B, t, 2) int32 mixed keys (kernel key family), the
        (B, t) slots the directory already holds for them, -1 for a miss,
        or None).  On the device path this is one :class:`DeviceHashPass`
        (``ops.lsh_hash_resolve`` against the device mirror of the
        directory); the host path hashes with the numpy mirror of the
        kernel and leaves every lookup to :meth:`_resolve_slots`."""
        if self.use_device:
            return self._hpass.run(X, self._dir)
        return self.lsh.device_keys_batch(
            np.ascontiguousarray(X, dtype=np.float32)), None

    # hot-path
    def _resolve_slots(self, keys32: np.ndarray,
                       hits: Optional[np.ndarray] = None) -> np.ndarray:
        """(B, t, 2) keys -> (B, t) slot ids, creating directory entries
        for unseen keys.  With ``hits`` (the device pass's slots, -1 for a
        miss) only the misses are looked at; they are allocated in the
        order the full lookup allocates them: tables in order, within a
        table the keys' ``np.unique`` order on the 8-byte view.  Without,
        one ``np.unique`` per table; Python touches only the unique keys,
        never the B·t key instances."""
        B = keys32.shape[0]
        self._ensure_slots(self._n_slots + B * self.t)
        if hits is not None:
            return self._resolve_misses(keys32, hits)
        void = np.ascontiguousarray(keys32).view(
            np.dtype((np.void, _KEY_W)))[..., 0]          # (B, t)
        slots = np.empty((B, self.t), np.int32)
        lut_buf = np.empty(B, np.int32)  # scratch reused across tables
        for i in range(self.t):
            uniq, inv = np.unique(void[:, i], return_inverse=True)
            table = self._dir[i]
            lut = lut_buf[:len(uniq)]
            for u, v in enumerate(uniq):
                kb = v.tobytes()
                s = table.get(kb)
                lut[u] = self._alloc_slot(i, kb) if s is None else s
            slots[:, i] = lut[inv]
        return slots

    def _resolve_misses(self, keys32: np.ndarray,
                        slots: np.ndarray) -> np.ndarray:
        """Fill the -1 entries of ``slots`` (in place) with new slots."""
        miss = slots < 0
        if not miss.any():
            return slots
        # each key's 8 bytes as a big-endian uint64: its numeric order is
        # the byte order np.unique gives the void view, at an integer
        # sort's cost
        big = np.ascontiguousarray(keys32).view(">u8")[..., 0]   # (B, t)
        for i in np.nonzero(miss.any(axis=0))[0]:
            rows = np.nonzero(miss[:, i])[0]
            uniq, inv = np.unique(big[rows, i], return_inverse=True)
            raw = uniq.astype(">u8", copy=False).tobytes()
            lut = np.fromiter((self._alloc_slot(int(i), raw[j:j + 8])
                               for j in range(0, len(raw), 8)),
                              np.int32, len(uniq))
            slots[rows, i] = lut[inv]
        return slots

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #
    def add_point(self, x: np.ndarray, idx: Optional[int] = None) -> int:
        return self.add_batch(
            np.asarray(x, dtype=np.float64)[None], ids=[idx])[0]

    # hot-path
    def add_batch(self, X: np.ndarray,
                  ids: Optional[Sequence[Optional[int]]] = None) -> List[int]:
        X = np.asarray(X, dtype=np.float64)
        if X.ndim != 2 or X.shape[1] != self.d:
            raise ValueError(f"batch shape {X.shape} != (n, {self.d})")
        if ids is not None and len(ids) != X.shape[0]:
            raise ValueError("ids length must match batch size")
        B = X.shape[0]
        if B == 0:
            return []
        k, t = self.core_k, self.t

        # -- claim handles (atomic: duplicates raise before any mutation)
        staged: Dict[int, int] = {}
        live = _LiveView(self._row, staged)
        out: List[int] = []
        for j in range(B):
            idx, self._next_idx = claim_index(
                live, self._next_idx, ids[j] if ids is not None else None)
            staged[idx] = j
            out.append(idx)

        # -- one device pass: hash -> slots -> occupancy deltas.  smask
        #    marks the core-eligible batch points (None = all; the
        #    sampled-core subclass narrows it), and the "core sizes" the
        #    crossings run on are whatever _batch_stats says drives
        #    support — bucket occupancy here, sampled occupancy there.
        keys32, hits = self._hash_batch(X)
        slots = self._resolve_slots(keys32, hits)
        ns = self._n_slots
        flat = slots.ravel()
        smask = self._elig_mask(out)
        core_old, core_new, occ_core, supp_batch = self._batch_stats(
            slots, flat, ns, smask)

        # -- threshold crossings: which slots crossed k, and at which step
        crossing = np.nonzero((core_old < k) & (core_new >= k))[0]
        cross_step = np.full(ns, B + 1, np.int64)      # B+1 = never crossed
        cross_step[core_new >= k] = -1                 # already >= k...
        if len(crossing):
            cross_step[crossing] = self._cross_steps(
                crossing, core_old, slots, smask)      # ...unless this batch

        # -- existing members of crossing buckets gain support (the
        #    sequential engine's "bucket crosses: every member gains")
        promoted_existing: Dict[int, int] = {}  # id -> core_time
        for s in crossing:
            step = int(cross_step[s])
            for m in self._core_members(int(s)):
                if not self._core_candidate(m):
                    continue
                r = self._row[m]
                self._support[r] += 1
                if self._support[r] == 1:
                    promoted_existing[m] = step
                elif m in promoted_existing:
                    # promotion time is the EARLIEST crossing bucket's step,
                    # not the first in slot-id order
                    promoted_existing[m] = min(promoted_existing[m], step)

        # -- membership: bulk per-slot set updates (grouped, C-speed)
        self._add_members(slots, out)
        step_of = staged  # id -> batch step, for event-time filtering

        # -- commit batch rows
        self._ensure_rows(self._top + B)
        rows = np.empty(B, np.int64)
        for j in range(B):
            r = self._free_rows.pop() if self._free_rows else self._top
            if r == self._top:
                self._top += 1
            rows[j] = r
            self._row[out[j]] = r
        self._ids[rows] = out
        self._pts[rows] = X
        self._keys32[rows] = keys32
        self._slots[rows] = slots
        self._support[rows] = supp_batch
        self._attach[rows] = -1

        # -- core_time per batch point: min over core buckets of
        #    max(insert step, bucket cross step); non-core = B+1
        steps = np.arange(B, dtype=np.int64)[:, None]
        cand = np.where(occ_core >= k,
                        np.maximum(cross_step[slots], steps), B + 1)
        if smask is not None:
            cand = np.where(smask[:, None], cand, B + 1)
        core_time = cand.min(axis=1)

        self._apply_insert_events(out, rows, slots, step_of, core_time,
                                  promoted_existing, occ_core)
        self._comp = None
        self._compact_journal()
        return out

    # ------------------------------------------------------------------ #
    # sampling hooks — the exact engine treats every point as core-
    # eligible; SampledCoreDBSCAN (core/approx.py) overrides these so
    # support runs on the sampled occupancy while membership/attachment
    # keep seeing every point.
    # ------------------------------------------------------------------ #
    def _elig_mask(self, ids: Sequence[int]) -> Optional[np.ndarray]:
        """(B,) bool core-eligibility of the given ids; None = all."""
        return None

    def _core_candidate(self, m: int) -> bool:
        """May ``m`` ever hold support (be a core point)?"""
        return True

    def _grab_skip(self, s: int) -> bool:
        """True when bucket ``s`` can hold no grabbable orphan (every
        member is a final core)."""
        return self._bsize[s] >= self.core_k

    def _core_sizes(self, ns: int) -> np.ndarray:
        """The per-slot sizes support thresholds run on (view)."""
        return self._bsize[:ns]

    def _core_members(self, s: int) -> Set[int]:
        """Members of slot ``s`` that may hold support or anchor a border
        — the pool crossings, demotions, scans and re-links walk.  The
        sampled-core subclass narrows it to the sampled members, which is
        what keeps deletion repair O(cores) instead of O(bucket)."""
        return self._members.get(s) or _EMPTY_MEMBERS

    def _member_discard(self, s: int, idx: int) -> None:
        """Remove ``idx`` from slot ``s``'s membership (single seam so
        subclasses keep any parallel member structures in sync)."""
        self._members[s].discard(idx)

    def _batch_stats(self, slots: np.ndarray, flat: np.ndarray, ns: int,
                     smask: Optional[np.ndarray]):
        """One array pass per insert batch — occupancy deltas + final
        per-point support, via the kernel pass (``use_device``) or its
        bit-exact numpy mirror.  Returns ``(core_old, core_new,
        occ_core, supp)``: the support-driving slot sizes before/after
        the batch, their per-(point, table) gather, and each batch
        point's final support."""
        if self.use_device:
            # one upload, one launch, one download; _bsize[:ns] is
            # updated in place from the download
            delta, supp = self._dpass.run(slots, self._bsize[:ns],
                                          self.core_k)
        else:
            delta = np.bincount(flat, minlength=ns).astype(np.int32)
            self._bsize[:ns] += delta
            supp = np.add.reduce(
                self._bsize[slots] >= self.core_k, axis=1, dtype=np.int32)
        new_sizes = self._bsize[:ns]
        return new_sizes - delta, new_sizes, self._bsize[slots], supp

    def _cross_steps(self, crossing: np.ndarray, core_old: np.ndarray,
                     slots: np.ndarray,
                     smask: Optional[np.ndarray]) -> np.ndarray:
        """Batch step at which each crossing slot reached size k: the
        (k - old_size)-th core-eligible arrival into the slot this batch.
        One stable argsort of the flat slot list; within a slot the order
        is by flat position, i.e. by batch step."""
        if smask is None:
            flat = slots.ravel()
            rows_map = None
        else:
            rows_map = np.nonzero(smask)[0]
            flat = slots[rows_map].ravel()
        order = np.argsort(flat, kind="stable")
        sf = flat[order]
        starts = np.searchsorted(sf, crossing)
        entry = starts + (self.core_k - core_old[crossing] - 1)
        steps = order[entry] // self.t
        return steps if rows_map is None else rows_map[steps]

    def _add_members(self, slots: np.ndarray, out: List[int]) -> None:
        for i in range(self.t):
            col = slots[:, i]
            order = np.argsort(col, kind="stable")
            sorted_ids = [out[j] for j in order]
            cs = col[order]
            bounds = np.nonzero(cs[1:] != cs[:-1])[0] + 1
            lo = 0
            for hi in list(bounds) + [len(cs)]:
                self._members[int(cs[lo])].update(sorted_ids[lo:hi])
                lo = hi

    # ------------------------------------------------------------------ #
    # insert-time events: promotions, orphan grabs, border scans
    # ------------------------------------------------------------------ #
    def _apply_insert_events(self, out, rows, slots, step_of, core_time,
                             promoted_existing, occ_final) -> None:
        """Replay the sequential engine's attachment decisions by event
        time (see module docstring).  All final-core batch points record a
        promotion; final-non-core batch points scan their buckets'
        cores-at-insert-time; promoted cores grab unattached orphans from
        their sub-threshold buckets at their promotion time."""
        k, B = self.k, len(out)
        INF = B + 1

        # promotion events: (time, id, slots_row) — batch cores + promoted
        # existing, exactly the sequential engine's sorted(promoted) sets
        events: List[Tuple[int, int, np.ndarray]] = []
        ctime: Dict[int, int] = {}
        core_js = np.nonzero(core_time <= B)[0]
        for j in core_js:
            ct = int(core_time[j])
            ctime[out[j]] = ct
            events.append((ct, out[j], slots[j]))
        for m, ct in promoted_existing.items():
            ctime[m] = ct
            r = self._row[m]
            old = int(self._attach[r]) if self._attach[r] >= 0 else None
            self._record(m, old, m)  # promotion delta (old = pre-batch)
            if old is not None:
                self.anchored[old].discard(m)
                self._attach[r] = -1
            events.append((ct, m, self._slots[r]))
        for j in core_js:
            self._record(out[j], None, out[j])
        self.n_promotions += len(events)

        # helper: is m core at time s (strictly before)?  -1 = pre-batch
        support = self._support
        row = self._row

        def _core_at(m: int, s: int) -> bool:
            ct = ctime.get(m)
            if ct is not None:
                return ct < s
            return support[row[m]] > 0 and m not in step_of

        # -- grab events: promoted core c, sub-threshold bucket, orphan y.
        # Orphan status (final support 0, no pre-batch anchor) is constant
        # through the replay — attachments only apply at the end — so the
        # loop is inverted: one vectorised sweep finds every orphan row,
        # and each orphan binary-searches its own slots' time-sorted event
        # lists for the earliest grab after its insertion.  A slot's list
        # is sorted by (time, id), so the first event with ct > step IS
        # min(ct, c) over that slot's qualifying grabs.  No orphan can
        # live in a slot the old per-slot walk skipped (all-core buckets
        # give every member support > 0), so no skip test is needed.
        best: Dict[int, Tuple[int, int]] = {}
        cand = (np.nonzero((support == 0) & (self._attach < 0)
                           & (self._ids != -1))[0]
                if self.attach_orphans and events else ())
        if len(cand):  # no orphans (dense exact case): skip event scatter
            tmp: Dict[int, List[Tuple[int, int]]] = {}
            for ct, c, srow in events:
                for s in srow:
                    tmp.setdefault(int(s), []).append((ct, c))
            evs_ct: Dict[int, np.ndarray] = {}
            evs_c: Dict[int, np.ndarray] = {}
            for s, lst in tmp.items():
                lst.sort()
                evs_ct[s] = np.fromiter((t for t, _ in lst), np.int64,
                                        len(lst))
                evs_c[s] = np.fromiter((c for _, c in lst), np.int64,
                                       len(lst))
            # only orphans sharing a bucket with a promotion can be
            # grabbed — with a stable core set (sampled tier) this drops
            # the persistent-noise sweep to near nothing
            ev_slots = np.fromiter(tmp, np.int64, len(tmp))
            ev_slots.sort()
            touch = np.isin(self._slots[cand], ev_slots).any(axis=1)
            cand = cand[touch]
        if len(cand):
            n_orph = len(cand)
            ids_c = self._ids[cand]
            steps = np.fromiter(
                (step_of.get(int(y), -1) for y in ids_c),
                np.int64, n_orph)
            S = self._slots[cand]                       # (n_orph, t)
            INF2 = np.iinfo(np.int64).max
            best_ct = np.full(n_orph, INF2, np.int64)
            best_c = np.full(n_orph, INF2, np.int64)
            # group (orphan, slot) pairs by slot: one bulk search per
            # slot instead of one Python bisect per pair
            flat = S.ravel()
            oidx = np.repeat(np.arange(n_orph), S.shape[1])
            order = np.argsort(flat, kind="stable")
            fs, fo = flat[order], oidx[order]
            cuts = np.nonzero(np.diff(fs))[0] + 1
            starts = np.concatenate([[0], cuts])
            ends = np.concatenate([cuts, [len(fs)]])
            for a, b in zip(starts, ends):
                s = int(fs[a])
                ect = evs_ct.get(s)
                if ect is None:
                    continue
                g = fo[a:b]
                pos = np.searchsorted(ect, steps[g], side="right")
                q = pos < len(ect)
                if not q.any():
                    continue
                g2, p2 = g[q], pos[q]
                ct2, c2 = ect[p2], evs_c[s][p2]
                upd = (ct2 < best_ct[g2]) | ((ct2 == best_ct[g2])
                                             & (c2 < best_c[g2]))
                if upd.any():
                    gi = g2[upd]
                    best_ct[gi] = ct2[upd]
                    best_c[gi] = c2[upd]
            for i in np.nonzero(best_ct < INF2)[0]:
                best[int(ids_c[i])] = (int(best_ct[i]),
                                       int(best_c[i]))

        # -- scan events: final-non-core batch points attach at insert.
        # A point m answers a scan at step j iff it is core strictly
        # before j: core time max(core_time_m, insert_step_m), with -1
        # for pre-batch cores.  Bulk form of "for each border, first
        # table whose slot holds such an m": one vectorised candidate
        # build over the final core set (restricted to the slots borders
        # actually touch), lexsorted by (slot, time, id) so a per-slot
        # slice is a time-sorted prefix-min table; then one grouped
        # searchsorted per touched slot.  This is the hot path when most
        # of a batch is non-core (approx tier); the exact engine's dense
        # case has no scan events at all.
        borders = np.nonzero(core_time > B)[0]
        if len(borders):
            nb, tw = len(borders), slots.shape[1]
            INF3 = np.iinfo(np.int64).max
            cand_id = np.full((nb, tw), INF3, np.int64)
            have = np.zeros((nb, tw), bool)
            flatb = slots[borders].ravel()
            bidx = np.repeat(np.arange(nb), tw)
            tpos = np.tile(np.arange(tw), nb)
            # a slot with no core-candidate members can never answer a
            # scan — drops most fringe buckets in the sampled subclass
            csz = self._core_sizes(self._n_slots)
            keep = csz[flatb] > 0
            flatb, bidx, tpos = flatb[keep], bidx[keep], tpos[keep]
        if len(borders) and len(flatb):
            needed = np.unique(flatb)
            # candidate pool: every final core (batch promotions carry
            # their event time; pre-batch cores time -1).  Batch points
            # with final support are always in ctime, so the override
            # loop below touches promotion events only.
            rowsE = np.nonzero((support > 0) & (self._ids != -1))[0]
            timesE = np.full(len(rowsE), -1, np.int64)
            for m, ct in ctime.items():
                st = step_of.get(m, -1)
                p = int(np.searchsorted(rowsE, row[m]))
                timesE[p] = ct if ct > st else st
            flatE = self._slots[rowsE].ravel()
            idsR = np.repeat(self._ids[rowsE], tw)
            timesR = np.repeat(timesE, tw)
            inn = np.isin(flatE, needed)
            flatE, idsR, timesR = flatE[inn], idsR[inn], timesR[inn]
        if len(borders) and len(flatb) and len(flatE):
            orderE = np.lexsort((idsR, timesR, flatE))
            fsE, tsE, msE = flatE[orderE], timesR[orderE], idsR[orderE]
            # per-slot running min of candidate id in time order, with no
            # per-segment loop: stagger segments by a large DECREASING
            # offset so a global min-accumulate can never carry a value
            # across a segment boundary (earlier segments sit strictly
            # above later ones), then subtract the offsets back out
            seg = np.cumsum(np.concatenate([[0], np.diff(fsE) != 0]))
            base = np.int64(msE.min())
            big = np.int64(msE.max()) - base + 1
            off = (np.int64(seg[-1]) - seg) * big
            pmin = np.minimum.accumulate(msE - base + off) - off + base
            # one composite-key search answers every (border, slot)
            # query: entries < slot*C + (j+1) in the lexsorted pool are
            # exactly this slot's candidates with time < j
            C = np.int64(B + 2)
            ckey = fsE.astype(np.int64) * C + (tsE + 1)
            qstart = np.searchsorted(fsE, flatb, side="left")
            pos = np.searchsorted(
                ckey, flatb.astype(np.int64) * C + (borders[bidx] + 1),
                side="left")
            q = pos > qstart
            bi, ti = bidx[q], tpos[q]
            have[bi, ti] = True
            cand_id[bi, ti] = pmin[pos[q] - 1]
            hit = have.any(axis=1)
            first = have.argmax(axis=1)  # first table in scan order
            for i in np.nonzero(hit)[0]:
                # the scan precedes any later grab
                best[out[borders[i]]] = (-1, int(cand_id[i, first[i]]))
        self.n_scan_events += len(borders)

        # -- apply attachments
        for y, (_, c) in best.items():
            ry = row[y]
            self._attach[ry] = c
            self.anchored.setdefault(c, set()).add(y)
            self._record(y, None, c)
        self.n_grab_events += len(best)

    # ------------------------------------------------------------------ #
    # deletion (sequential mirror of DynamicDBSCAN.delete_point; the
    # accounting is array ops, and no forest repair is ever needed)
    # ------------------------------------------------------------------ #
    def delete_point(self, idx: int) -> None:
        self._delete_one(idx)
        self._comp = None
        self._compact_journal()

    def delete_batch(self, ids: Sequence[int]) -> None:
        """One array pass per batch: departure counts, threshold-crossing
        steps, and the occupancy decrement are computed for the whole
        batch up front (bincount + one stable argsort — the deletion
        mirror of ``add_batch``'s insert pass); the per-point Python work
        that remains is event-scale only (journal records, border
        re-links, demotion cascades), replayed in deletion order so the
        result is bit-identical to the sequential path."""
        check_unique_ids(ids)
        ids = [int(i) for i in ids]
        if len(ids) <= 1 or any(i not in self._row for i in ids):
            # tiny batches gain nothing from the array pass; a missing id
            # keeps the sequential partial-prefix KeyError semantics
            for i in ids:
                self._delete_one(i)
            self._comp = None
            self._compact_journal()
            return
        k, t, D = self.core_k, self.t, len(ids)
        rows_d = np.fromiter((self._row[i] for i in ids), np.int64, D)
        slots_d = self._slots[rows_d]                  # (D, t)
        ns = self._n_slots
        flat_d = slots_d.ravel()
        dep = np.bincount(flat_d, minlength=ns).astype(np.int32)
        smask = self._elig_mask(ids)  # same eligibility as on insert
        if smask is None:
            core_dep, core_flat, rows_map = dep, flat_d, None
        else:
            rows_map = np.nonzero(smask)[0]
            core_flat = slots_d[rows_map].ravel()
            core_dep = np.bincount(core_flat, minlength=ns).astype(np.int32)
        core_old = self._core_sizes(ns).copy()
        core_new_sz = core_old - core_dep
        new_sizes = self._bsize[:ns] - dep

        # threshold down-crossings: the (old - k + 1)-th core-eligible
        # departure drops the slot's core size below k, at that step
        cross_slots = np.nonzero((core_old >= k) & (core_new_sz < k))[0]
        cross_at: Dict[int, List[int]] = {}
        if len(cross_slots):
            order = np.argsort(core_flat, kind="stable")
            sf = core_flat[order]
            starts = np.searchsorted(sf, cross_slots)
            entry = starts + (core_old[cross_slots] - k)
            steps = order[entry] // t
            if rows_map is not None:
                steps = rows_map[steps]
            for s, j in zip(cross_slots, steps):
                cross_at.setdefault(int(j), []).append(int(s))

        self._apply_occupancy_delta(dep, core_dep, ns)

        # replay the sequential deletion events in batch order.  Border
        # re-links are DEFERRED to one pass at the end: a disturbed
        # border's sequential anchor is the min candidate, in the first
        # table holding any, at its LAST re-link — and since candidate
        # sets only shrink during a delete batch (no inserts, demotions
        # only) while the chosen anchor by definition survives, that
        # equals the min live core at batch end.  The sequential path's
        # intermediate hops (re-anchor to a core deleted later in the
        # batch, cascading more re-links) net out of the compacted
        # journal, so state and delta feed are both bit-identical.
        pending: Set[int] = set()
        for j, idx in enumerate(ids):
            row = self._row[idx]
            self._record(idx, self._attach_handle(idx), None)
            if self._support[row] > 0:
                for y in self.anchored.pop(idx, ()):
                    self._attach[self._row[y]] = -1
                    self._record(y, idx, None)
                    pending.add(y)
            else:
                a = int(self._attach[row])
                if a >= 0:
                    self.anchored[a].discard(idx)
            for i in range(t):
                self._member_discard(int(slots_d[j, i]), idx)
            demoted: List[int] = []
            for s in cross_at.get(j, ()):
                for y in self._core_members(s):
                    if not self._core_candidate(y):
                        continue
                    ry = self._row[y]
                    self._support[ry] -= 1
                    if self._support[ry] == 0:
                        demoted.append(y)
            for c in sorted(demoted):
                for y in self.anchored.pop(c, ()):
                    self._attach[self._row[y]] = -1
                    self._record(y, c, None)
                    pending.add(y)
                self._record(c, c, None)
                pending.add(c)
            self.n_demotions += len(demoted)
            self._ids[row] = -1
            self._support[row] = 0
            self._attach[row] = -1
            self._free_rows.append(row)
            del self._row[idx]

        # end-of-batch re-link: min live core per slot, computed once per
        # slot and shared across every disturbed border (the sequential
        # cascade touches the same blob buckets over and over)
        slot_best: Dict[int, int] = {}
        for y in pending:
            ry = self._row.get(y)
            if ry is None:  # disturbed, then deleted later in the batch
                continue
            for i in range(t):
                s = int(self._slots[ry, i])
                c = slot_best.get(s, -2)
                if c == -2:
                    c = min((m for m in self._core_members(s)
                             if self._support[self._row[m]] > 0),
                            default=-1)
                    slot_best[s] = c
                if c >= 0:
                    self._attach[ry] = c
                    self.anchored.setdefault(c, set()).add(y)
                    self._record(y, None, c)
                    break

        # emptied slots free once, at the end (their member sets emptied
        # exactly when the final size reached zero)
        for s in np.nonzero((dep > 0) & (new_sizes == 0))[0]:
            self._free_slot(int(s))
        self._comp = None
        self._compact_journal()

    def _apply_occupancy_delta(self, dep: np.ndarray, core_dep: np.ndarray,
                               ns: int) -> None:
        """Batched occupancy decrement (delete mirror of _batch_stats)."""
        self._bsize[:ns] -= dep
        self._sizes_changed()

    def _delete_one(self, idx: int) -> None:
        if idx not in self._row:
            raise KeyError(idx)
        row = self._row[idx]
        self._record(idx, self._attach_handle(idx), None)

        unchained: Set[int] = {idx}
        if self._support[row] > 0:
            # chains lose idx first; its borders re-scan against the rest
            for y in list(self.anchored.pop(idx, ())):
                self._attach[self._row[y]] = -1
                self._record(y, idx, None)
                self._relink(y, (), unchained)
        else:
            a = int(self._attach[row])
            if a >= 0:
                self.anchored[a].discard(idx)

        demoted: List[int] = []
        for i in range(self.t):
            s = int(self._slots[row, i])
            self._member_discard(s, idx)
            if self._bucket_shrink(s, idx):
                # bucket drops below threshold: members lose support
                for y in self._core_members(s):
                    if not self._core_candidate(y):
                        continue
                    ry = self._row[y]
                    self._support[ry] -= 1
                    if self._support[ry] == 0:
                        demoted.append(y)
            if self._bsize[s] == 0:
                self._free_slot(s)

        demoted_set = set(demoted)
        for c in sorted(demoted):
            # c leaves the chains, then its borders re-scan, then c itself
            unchained.add(c)
            for y in list(self.anchored.pop(c, ())):
                self._attach[self._row[y]] = -1
                self._record(y, c, None)
                self._relink(y, demoted_set, unchained)
            self._record(c, c, None)
            self._relink(c, demoted_set, unchained)
        self.n_demotions += len(demoted)

        self._ids[row] = -1
        self._support[row] = 0
        self._attach[row] = -1
        self._free_rows.append(row)
        del self._row[idx]

    def _bucket_shrink(self, s: int, idx: int) -> bool:
        """Remove one occupant from slot ``s``; True when the removal
        dropped the slot's support-driving size below the threshold."""
        self._bsize[s] -= 1
        self._sizes_changed()
        return self._bsize[s] == self.core_k - 1

    def _sizes_changed(self) -> None:
        """The host changed the sizes outside an insert pass: the device
        mirror is stale until the next pass uploads them."""
        if self.use_device:
            self._dpass.mark_stale()

    def _relink(self, y: int, demoted_set: Set[int],
                unchained: Set[int]) -> None:
        """LinkNonCorePoint against the *chained* set: current cores plus
        still-chained demoted points (the sequential engine removes a
        demoted core's chain entries only when its turn comes, so earlier
        re-links can legally anchor to it; the later unlink re-scans)."""
        ry = self._row[y]
        for i in range(self.t):
            s = int(self._slots[ry, i])
            cands = [m for m in self._core_members(s)
                     if m != y and m not in unchained
                     and (self._support[self._row[m]] > 0
                          or m in demoted_set)]
            if cands:
                c = min(cands)
                self._attach[ry] = c
                self.anchored.setdefault(c, set()).add(y)
                self._record(y, None, c)
                return

    # ------------------------------------------------------------------ #
    # queries
    # ------------------------------------------------------------------ #
    def is_core(self, idx: int) -> bool:
        return self._support[self._row[idx]] > 0

    def core_set(self) -> Set[int]:
        return {i for i, r in self._row.items() if self._support[r] > 0}

    def core_anchor(self, idx: int) -> Optional[int]:
        r = self._row[idx]
        if self._support[r] > 0:
            return idx
        a = int(self._attach[r])
        return a if a >= 0 else None

    def _ensure_comp(self) -> np.ndarray:
        if self._comp is not None:
            return self._comp
        rows = np.fromiter(self._row.values(), np.int64, len(self._row))
        core_rows = rows[self._support[rows] > 0]
        a = b = np.zeros(0, np.int64)
        if len(core_rows):
            S = self._slots[core_rows]                    # (m, t)
            flat = S.ravel()
            rep = np.repeat(core_rows, self.t)
            order = np.argsort(flat, kind="stable")
            sf, rf = flat[order], rep[order]
            same = sf[1:] == sf[:-1]
            a, b = rf[:-1][same], rf[1:][same]
        parent = _sv_components(self._top, a, b)
        comp = np.full(self._cap, -1, np.int64)
        if len(core_rows):
            comp[core_rows] = self._ids[parent[core_rows]]
        self._comp = comp
        self.n_epoch_rebuilds += 1
        if self.obs.enabled:
            # the rebuild's work, which grows with the window, not the batch
            self.obs.counter("engine.comp_rebuild_rows").inc(len(core_rows))
        return comp

    def get_cluster(self, idx: int):
        """Component handle: the id of the component's representative core
        for cores and attached borders, the point's own id for noise."""
        r = self._row[idx]  # KeyError on dead ids, like forest.root
        if self._support[r] > 0:
            return int(self._ensure_comp()[r])
        a = int(self._attach[r])
        if a < 0:
            return int(idx)
        return int(self._ensure_comp()[self._row[a]])

    component_of = get_cluster

    def labels(self, ids: Optional[Iterable[int]] = None) -> Dict[int, int]:
        """Canonical labels; noise -> NOISE.  Components are numbered by
        first occurrence in ``ids`` order (noise singletons consume a
        number before the NOISE overwrite), matching ``DynamicDBSCAN``.

        Note: with an explicit ``ids`` subset, components are the *global*
        components restricted to the subset — the dict engines label the
        forest subgraph instead, which can split a component whose
        connecting cores were excluded.  Full ``labels()`` is identical.
        """
        id_list = list(self._row.keys()) if ids is None else list(ids)
        comp = self._ensure_comp()
        out: Dict[int, int] = {}
        relabel: Dict[int, int] = {}
        for v in id_list:
            r = self._row[v]
            if self._support[r] > 0:
                h = int(comp[r])
                noise = False
            else:
                a = int(self._attach[r])
                noise = a < 0
                h = int(v) if noise else int(comp[self._row[a]])
            num = relabel.setdefault(h, len(relabel))
            out[v] = NOISE if noise else num
        return out

    # ------------------------------------------------------------------ #
    # change feed (same contract as DynamicDBSCAN)
    # ------------------------------------------------------------------ #
    def _record(self, idx: int, old: Optional[int],
                new: Optional[int]) -> None:
        if self._journal is not None:
            self._journal.append((idx, old, new))

    def _attach_handle(self, idx: int) -> Optional[int]:
        r = self._row[idx]
        if self._support[r] > 0:
            return idx
        a = int(self._attach[r])
        return a if a >= 0 else None

    def _compact_journal(self) -> None:
        if not self._journal:
            return
        merged: Dict[int, List[Optional[int]]] = {}
        for idx, old, new in self._journal:
            if idx in merged:
                merged[idx][1] = new
            else:
                merged[idx] = [old, new]
        self._journal = [(i, o, n) for i, (o, n) in merged.items() if o != n]

    def drain_deltas(self) -> List[Tuple[int, Optional[int], Optional[int]]]:
        if self._journal is None:
            self._journal = []
            return []
        self._compact_journal()
        out, self._journal = self._journal, []
        return out

    # ------------------------------------------------------------------ #
    # checkpointable state (dynamic-compatible schema)
    # ------------------------------------------------------------------ #
    def state_dict(self) -> Dict[str, np.ndarray]:
        ids = sorted(self._row)
        n = len(ids)
        rows = np.fromiter((self._row[i] for i in ids), np.int64, n)
        keys = (np.ascontiguousarray(self._keys32[rows])
                .view(np.uint8).reshape(n, self.t, _KEY_W)
                if n else np.zeros((0, self.t, 0), np.uint8))
        edges = self._edge_list(rows)
        return {
            "ids": np.asarray(ids, dtype=np.int64),
            "points": self._pts[rows].copy(),
            "keys": keys,
            "support": self._support[rows].astype(np.int64),
            "attach": self._attach[rows].copy(),
            "edges": edges,
            "next_idx": np.asarray(self._next_idx, dtype=np.int64),
        }

    def _edge_list(self, rows: np.ndarray) -> np.ndarray:
        """Configuration-canonical spanning edges: consecutive core ids
        per bucket chain plus (border, anchor) edges — the same component
        structure the forest engines persist, minus the history-dependent
        replacement edges."""
        core_rows = rows[self._support[rows] > 0]
        parts = []
        if len(core_rows):
            cid = self._ids[core_rows]
            srt = np.argsort(cid)
            core_rows, cid = core_rows[srt], cid[srt]
            S = self._slots[core_rows]
            flat = S.ravel()
            rep = np.repeat(cid, self.t)
            order = np.argsort(flat, kind="stable")  # id-sorted within slot
            sf, rf = flat[order], rep[order]
            same = sf[1:] == sf[:-1]
            parts.append(np.stack([rf[:-1][same], rf[1:][same]], axis=1))
        att_rows = rows[(self._support[rows] == 0) & (self._attach[rows] >= 0)]
        if len(att_rows):
            parts.append(np.stack(
                [self._ids[att_rows], self._attach[att_rows]], axis=1))
        if not parts:
            return np.zeros((0, 2), np.int64)
        e = np.concatenate(parts).astype(np.int64)
        e = np.stack([e.min(axis=1), e.max(axis=1)], axis=1)
        return np.unique(e, axis=0)

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        if self._row:
            raise ValueError("load_state_dict requires an empty structure")
        ids = [int(i) for i in state["ids"]]
        n = len(ids)
        points = np.asarray(state["points"], dtype=np.float64)
        keys = np.asarray(state["keys"], dtype=np.uint8)
        if n and keys.shape[2] != _KEY_W:
            raise ValueError(
                "soa restores mixed device keys (width 8); got width "
                f"{keys.shape[2]} — snapshot from an exact-key backend")
        support = np.asarray(state["support"], dtype=np.int64)
        attach = np.asarray(state["attach"], dtype=np.int64)
        self._ensure_rows(n)
        rows = np.arange(n, dtype=np.int64)
        self._top = n
        for j, i in enumerate(ids):
            self._row[i] = j
        keys32 = (keys.view(np.int32).reshape(n, self.t, 2)
                  if n else np.zeros((0, self.t, 2), np.int32))
        slots = self._resolve_slots(keys32) if n else np.zeros(
            (0, self.t), np.int32)
        self._dir_changed()
        self._ids[rows] = ids
        self._pts[rows] = points
        self._keys32[rows] = keys32
        self._slots[rows] = slots
        self._support[rows] = support
        self._attach[rows] = attach
        if n:
            self._bsize[:self._n_slots] = np.bincount(
                slots.ravel(), minlength=self._n_slots).astype(np.int32)
            self._sizes_changed()
            self._add_members(slots, ids)
            # stored support must match the restored configuration
            recomputed = self._rebuild_support(slots, ids)
            if not np.array_equal(recomputed, support):
                raise ValueError("snapshot support counts do not match "
                                 "the restored bucket configuration")
        for j, i in enumerate(ids):
            a = int(attach[j])
            if a >= 0:
                self.anchored.setdefault(a, set()).add(i)
        self._next_idx = int(state["next_idx"])
        self._comp = None

    def _rebuild_support(self, slots: np.ndarray,
                         ids: List[int]) -> np.ndarray:
        """Per-point support implied by the restored configuration."""
        return np.add.reduce(self._bsize[slots] >= self.core_k, axis=1)

    # ------------------------------------------------------------------ #
    # invariants (tests)
    # ------------------------------------------------------------------ #
    def check_invariants(self) -> None:
        rows = np.fromiter(self._row.values(), np.int64, len(self._row))
        ids = np.fromiter(self._row.keys(), np.int64, len(self._row))
        if len(rows) == 0:
            assert not self._members  # every bucket freed when it emptied
            return
        core_ids = {int(i) for i, r in zip(ids, rows)
                    if self._support[r] > 0}
        self._check_counts(rows, ids, core_ids)
        if self.use_device:
            self._check_device_mirrors()
        # 3. attachment validity: anchor is a live core sharing a bucket;
        #    unattached non-core points see no core in any bucket (noise)
        for i, r in zip(ids, rows):
            i, r = int(i), int(r)
            if self._support[r] > 0:
                assert self._attach[r] == -1
                continue
            a = int(self._attach[r])
            if a >= 0:
                ra = self._row[a]
                assert self._support[ra] > 0, (i, a)
                assert i in self.anchored.get(a, set())
                shared = set(self._slots[r]) & set(self._slots[ra])
                assert shared, (i, a)
            elif self.attach_orphans:
                # with grabs disabled a point promoted *after* y's insert
                # legally coexists with unattached y, so only assert the
                # noise condition when orphan re-attachment is on
                for s in self._slots[r]:
                    # cores are always core-candidates, so the candidate
                    # pool view suffices (and stays valid for the
                    # sampled subclass, which keeps no full membership)
                    mem = self._core_members(int(s))
                    assert not (mem & core_ids) - {i}, (i, int(s))
        # 4. anchored maps mirror attach exactly
        n_anch = sum(len(v) for v in self.anchored.values())
        assert n_anch == int(np.sum(
            (self._support[rows] == 0) & (self._attach[rows] >= 0)))
        # 5. every core pair sharing a bucket shares a component (Thm 2)
        comp = self._ensure_comp()
        for s in list(self._members):
            cs = [m for m in self._core_members(s) if m in core_ids]
            if len(cs) > 1:
                h0 = comp[self._row[cs[0]]]
                assert all(comp[self._row[c]] == h0 for c in cs[1:])

    def _check_device_mirrors(self) -> None:
        """Fresh device mirrors equal the host state they follow: the
        sizes (the sampled-core subclass adds its sampled sizes) and the
        bucket directory."""
        self._dpass.check(self._bsize, self._n_slots)
        self._hpass.check(self._dir)

    def _check_counts(self, rows: np.ndarray, ids: np.ndarray,
                      core_ids: Set[int]) -> None:
        # 1. support counts are exact
        occ = self._bsize[self._slots[rows]]
        assert np.array_equal(
            np.add.reduce(occ >= self.core_k, axis=1), self._support[rows])
        # 2. bucket sizes match membership; >=k buckets are all-core
        for s, mem in self._members.items():
            assert self._bsize[s] == len(mem), (s, self._bsize[s], len(mem))
            if len(mem) >= self.core_k:
                assert all(m in core_ids for m in mem)

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return len(self._row)

    def __contains__(self, idx: int) -> bool:
        return idx in self._row
