"""Plain PyTorch versions of the port's kernels.

Mirrors of ``repro.kernels.ref`` (``lsh_hash``, ``slot_counts``,
``bucket_core_stats``, ``eps_neighbor_counts``, ``attention``) that run
on any device, ``bucket_insert_pass``, the engine's insert batch as
the two bucket kernels composed, and ``lsh_hash_resolve``, the engine's
hash pass: the keys and their slots in a directory table.  On a CPU
tensor the
wrappers in :mod:`.ops` run these; on the card they are what each CUDA
kernel is held against: bit for bit, and ``attention`` within the
reference tests' tolerances (its kernel sums in another f32 order).

One deliberate difference from ``repro.kernels.ref``: an id outside
``[0, n)`` contributes nothing to ``slot_counts`` or
``bucket_core_stats``, as in the TPU kernels, where ``repro.kernels.ref``
wraps a negative id like numpy indexing.  The engine never produces such
ids.

Integer arithmetic is done in int64 and folded back to int32: torch's
``>>`` on int32 is arithmetic, not logical, and int32 multiplication is
not guaranteed to wrap.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# the reference's finalizer constants (repro/kernels/ref.py MIX_A = -1975444243,
# MIX_B = -1029739211) as unsigned 32-bit values.  Its comments name
# murmur3's 0x85EBCA6D / 0xC2B2AE35, but the keys are defined by the
# values, and these are they.
MIX_A = 0x8A411CED
MIX_B = 0xC29F6D35
_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """``(h * m) mod 2^32`` for int64 ``h`` in ``[0, 2^32)``: split ``h``
    in 16-bit halves so no int64 product overflows."""
    lo = (h & 0xFFFF) * m
    hi = ((h >> 16) * m) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _avalanche(h: torch.Tensor) -> torch.Tensor:
    """murmur3-style finalizer on int64 values in ``[0, 2^32)``; the shifts are
    logical because the values are non-negative."""
    h = h ^ (h >> 16)
    h = _mul32(h, MIX_A)
    h = h ^ (h >> 13)
    h = _mul32(h, MIX_B)
    return h ^ (h >> 16)


def _to_int32(h: torch.Tensor) -> torch.Tensor:
    """Reinterpret int64 values in ``[0, 2^32)`` as int32."""
    return torch.where(h >= 2**31, h - 2**32, h).to(torch.int32)


def lsh_hash(x: torch.Tensor, eta: torch.Tensor, mixers: torch.Tensor,
             inv_cell: float) -> torch.Tensor:
    """Grid-LSH bucket keys.

    x:      (n, d) float32 points
    eta:    (t,)   float32 per-table offsets
    mixers: (2, t, d) int32 odd multipliers
    returns (n, t, 2) int32 keys, bit-identical to
    ``repro.kernels.ref.lsh_hash``.
    """
    inv = torch.tensor(np.float32(inv_cell), dtype=torch.float32,
                       device=x.device)
    # two separate f32 ops, in this order: (x + eta) then * inv_cell
    shifted = x[:, None, :] + eta[None, :, None]
    codes = torch.floor(shifted * inv).to(torch.int32).to(torch.int64)
    m = mixers.to(torch.int64)
    # each product fits int64 (|code|, |mixer| < 2^31); masking it to 32
    # bits keeps the sum over d exact before the final mod 2^32
    acc_a = ((codes * m[0][None]) & _M32).sum(-1) & _M32
    acc_b = ((codes * m[1][None]) & _M32).sum(-1) & _M32
    return torch.stack([_to_int32(_avalanche(acc_a)),
                        _to_int32(_avalanche(acc_b))], dim=-1)


#: slot word of an empty directory cell and of a tombstone
EMPTY, TOMBSTONE = -1, -2


def probe(directory: torch.Tensor, table: torch.Tensor, ka: torch.Tensor,
          kb: torch.Tensor):
    """Linear probes of an open-addressing directory (cap, 4) int32 of
    ``[key a, key b, table, slot]`` cells (cap a power of two) for the
    (table, key) queries given as equal-shaped int32 tensors, each from
    cell ``key a mod cap`` to the cell holding it live or to the first
    empty cell.  Returns (the live cell of each query or -1, the number of
    cells each probe read), both int64 of the queries' shape."""
    cap = directory.shape[0]
    mask = cap - 1
    shape = ka.shape
    table, ka, kb = (v.reshape(-1) for v in (table, ka, kb))
    # low bits of the two's complement word, as (uint32)a & mask
    pos = ka.to(torch.int64) & mask
    found = torch.full_like(pos, -1)
    steps = torch.zeros_like(pos)
    active = torch.arange(pos.numel(), device=pos.device)
    # one vectorised step of every live probe a round, as many rounds as
    # the longest probe chain (the plain version of a kernel)
    for _ in range(cap):  # analysis: allow[HOT001]
        if active.numel() == 0:
            break
        p = pos[active]
        c = directory[p]
        steps[active] += 1
        hit = ((c[:, 3] >= 0) & (c[:, 0] == ka[active])
               & (c[:, 1] == kb[active]) & (c[:, 2] == table[active]))
        found[active[hit]] = p[hit]
        active = active[~hit & (c[:, 3] != EMPTY)]
        pos[active] = (pos[active] + 1) & mask
    return found.reshape(shape), steps.reshape(shape)


def _insert_absent(directory: torch.Tensor, cells: torch.Tensor) -> None:
    """Write ``cells`` (m, 4), keys the directory does not hold, each into
    the first empty or tombstone cell of its probe chain; where several
    want one cell, the first in ``cells`` takes it and the others go on."""
    cap, m = directory.shape[0], cells.shape[0]
    mask = cap - 1
    pos = cells[:, 0].to(torch.int64) & mask
    left = torch.arange(m, device=cells.device)
    # one vectorised step of every unplaced cell a round, as many rounds
    # as the longest probe chain (the plain version of a kernel)
    for _ in range(cap + m):  # analysis: allow[HOT001]
        if left.numel() == 0:
            return
        p = pos[left]
        free = directory[p, 3] < 0
        want, at = left[free], p[free]
        first = torch.full((cap,), m, dtype=torch.int64, device=cells.device)
        first.scatter_reduce_(0, at, want, "amin")
        won = want[first[at] == want]
        directory[pos[won]] = cells[won]
        taken = torch.zeros(m, dtype=torch.bool, device=cells.device)
        taken[won] = True
        moved = left[~free]
        pos[moved] = (pos[moved] + 1) & mask
        left = left[~taken[left]]
    raise RuntimeError("directory full")


def lsh_hash_resolve(x: torch.Tensor, eta: torch.Tensor,
                     mixers: torch.Tensor, inv_cell: float,
                     directory: torch.Tensor, updates: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The engine's hash pass against a directory table.

    x, eta, mixers, inv_cell: as :func:`lsh_hash`
    directory: (cap, 4) int32 cells ``[key a, key b, table, slot]``, cap a
               power of two, slot ``EMPTY`` or ``TOMBSTONE`` for a free
               cell; updated IN PLACE
    updates:   (u, 4) int32 ``[key a, key b, table, slot]``, each (table,
               key) at most once: a live key takes the new slot (a
               tombstone for slot -1), an absent key with a slot >= 0 is
               inserted, an erase of an absent key does nothing
    returns ``out[:3 n t]`` (allocated when ``out`` is None), int32: the
    keys ``lsh_hash(x, eta, mixers, inv_cell)`` (n, t, 2), then the slot
    the directory holds for each (point, table) key after the updates,
    -1 where it holds none.  Cell positions may differ from the CUDA
    kernel's (its inserts land in no fixed order); the output does not."""
    keys = lsh_hash(x, eta, mixers, inv_cell)
    n, t = keys.shape[:2]
    if updates.shape[0]:
        found, _steps = probe(directory, updates[:, 2], updates[:, 0],
                              updates[:, 1])
        hit = found >= 0
        new = updates[hit, 3]
        directory[found[hit], 3] = torch.where(
            new >= 0, new, torch.full_like(new, TOMBSTONE))
        _insert_absent(directory, updates[~hit & (updates[:, 3] >= 0)])
    tables = torch.arange(t, dtype=torch.int32, device=x.device).expand(n, t)
    found, _steps = probe(directory, tables, keys[..., 0], keys[..., 1])
    slots = torch.where(found >= 0, directory[found.clamp(min=0), 3],
                        torch.full_like(found, -1, dtype=torch.int32))
    if out is None:
        out = torch.empty(3 * n * t, dtype=torch.int32, device=x.device)
    out = out[:3 * n * t]
    out[:2 * n * t] = keys.reshape(-1)
    out[2 * n * t:] = slots.reshape(-1)
    return out


def slot_counts(slots: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Occupancy histogram of a batch's (n, t) slot matrix:
    ``out[s] = #{(p, i) : slots[p, i] == s}`` for ``s`` in
    ``[0, n_slots)``; other ids are dropped."""
    flat = slots.reshape(-1).to(torch.int64)
    flat = flat[(flat >= 0) & (flat < n_slots)]
    out = torch.zeros(n_slots, dtype=torch.int32, device=slots.device)
    return out.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))


def bucket_core_stats(slots: torch.Tensor, sizes: torch.Tensor, k: int):
    """Definition-4 support counts from bucket occupancies.

    slots: (n, t) int32 bucket-slot ids
    sizes: (nb,) int32 occupancy per slot
    returns (support, core): (n,) int32 ``#{i : sizes[slots[p,i]] >= k}``
    over the ids in ``[0, nb)``, and ``support > 0`` as int32.
    """
    nb = sizes.shape[0]
    s = slots.to(torch.int64)
    valid = (s >= 0) & (s < nb)
    # invalid ids read a zero appended past the end and are masked out
    padded = torch.cat([sizes, sizes.new_zeros(1)])
    occ = padded[torch.where(valid, s, nb)]
    supp = (valid & (occ >= k)).sum(dim=-1, dtype=torch.int32)
    return supp, (supp > 0).to(torch.int32)


def bucket_insert_pass(slots: torch.Tensor, sizes: torch.Tensor, k: int,
                       out: Optional[torch.Tensor] = None,
                       core_sizes: Optional[torch.Tensor] = None,
                       row_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """An insert batch's bucket statistics against a size table.

    slots: (n, t) int32 bucket-slot ids of the batch
    sizes: (nb,) int32 occupancy per slot, updated IN PLACE:
           ``sizes += slot_counts(slots, nb)``
    returns ``out[:nb + n]`` (allocated when ``out`` is None), int32:
    the new sizes, then each point's support against them
    (``bucket_core_stats(slots, new sizes, k)[0]``).  Ids outside
    ``[0, nb)`` contribute nothing to either.

    With ``core_sizes`` (nb,) int32 and ``row_mask`` (n,) bool or uint8
    (both or neither) the support runs on the second table instead, the
    sampled-core engine's: ``core_sizes += slot_counts(slots[row_mask])``
    (the masked rows only, updated IN PLACE), and every row's support is
    counted against the new ``core_sizes``; returns ``out[:2 nb + n]`` =
    [new sizes | new core sizes | support]."""
    nb, n = sizes.shape[0], slots.shape[0]
    if (core_sizes is None) != (row_mask is None):
        raise ValueError("bucket_insert_pass: core_sizes and row_mask "
                         "come together")
    sizes += slot_counts(slots, nb)
    gate, head = sizes, nb
    if core_sizes is not None:
        core_sizes += slot_counts(slots[row_mask.to(torch.bool)], nb)
        gate, head = core_sizes, 2 * nb
    supp, _core = bucket_core_stats(slots, gate, k)
    if out is None:
        out = torch.empty(head + n, dtype=torch.int32, device=sizes.device)
    out = out[:head + n]
    out[:nb] = sizes
    if core_sizes is not None:
        out[nb:head] = core_sizes
    out[head:] = supp
    return out


#: rows of the (rows, n) distance block :func:`eps_neighbor_counts` holds
#: at once are chosen so that one f32 temporary stays under this many bytes
_EPS_BLOCK_BYTES = 1 << 28


def eps_threshold(eps: float) -> float:
    """``float32(eps*eps + 1e-6)``: the sum taken in Python double and
    rounded to f32 once, as JAX's weak-typed scalar does in
    ``repro.kernels.ref`` and the Pallas kernel."""
    # analysis: allow[HOT002] eps is a Python float: no tensor is read
    return float(np.float32(eps * eps + 1e-6))


def eps_neighbor_counts(x: torch.Tensor, eps: float) -> torch.Tensor:
    """|B(x_i, eps)| per point, self included: (n, d) f32 -> (n,) int32.

    The arithmetic order is fixed, and the CUDA kernel follows it:
    ``s_i = sum_k x_ik*x_ik`` and ``dot_ij = sum_k x_ik*x_jk`` summed for
    k = 0..d-1 with every product and sum a separate f32 op (no
    ``matmul``, ``addcmul`` or ``einsum``, which may fuse or reorder), then
    ``d2 = (s_i + s_j) - 2*dot_ij`` and a count of ``d2 <= thr`` with
    ``thr = eps_threshold(eps)``.  Rows go in blocks so that no temporary
    exceeds ``_EPS_BLOCK_BYTES``."""
    n, d = x.shape
    thr = eps_threshold(eps)
    s = torch.zeros(n, dtype=torch.float32, device=x.device)
    # analysis: allow[HOT001] the fixed order of the sums over k (above)
    for k in range(d):
        s = s + x[:, k] * x[:, k]
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    rows = max(1, _EPS_BLOCK_BYTES // (4 * max(n, 1)))
    # analysis: allow[HOT001] row blocks bound the (rows, n) temporaries
    for r0 in range(0, n, rows):
        r1 = min(r0 + rows, n)
        dot = torch.zeros((r1 - r0, n), dtype=torch.float32, device=x.device)
        # analysis: allow[HOT001] the fixed order of the sums over k
        for k in range(d):
            dot.add_(x[r0:r1, k, None] * x[None, :, k])
        d2 = (s[r0:r1, None] + s[None, :]) - 2.0 * dot
        out[r0:r1] = (d2 <= thr).sum(dim=1, dtype=torch.int32)
    return out


#: the masked score of ``attention`` (``repro.kernels.ref``: ``-1e30``)
NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0,
              scale: Optional[float] = None) -> torch.Tensor:
    """Reference GQA attention, as ``repro.kernels.ref.attention``.

    q: (b, hq, sq, dh); k, v: (b, hkv, skv, dh) with hq % hkv == 0; query
    head h reads kv head ``h // (hq // hkv)``.  ``q_offset``: absolute
    position of q[0] (for decode: skv - sq).  ``window``: keys with
    ``q_pos - k_pos >= window`` are masked; None = full.

    The logits einsum runs in the inputs' dtype and is then cast to f32
    (for bf16 inputs the logits are rounded to bf16 first, as in the
    reference; f64 inputs stay f64); softmax is f32 (f64); the
    probabilities are cast back to v's dtype for the second einsum.  A
    row whose keys are all masked gets the mean of v, as in the
    reference (the kernel writes 0 there).
    """
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    # f32 scores (f64 inputs keep f64, so that gradcheck can probe it)
    score_dtype = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, kk).to(score_dtype) \
        * scale
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    logits = logits.masked_fill(~mask[None, None], NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(vv.dtype), vv)
