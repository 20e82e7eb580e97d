"""Directory scenarios for the port's hash-and-resolve pass
(``repro_torch.kernels.ops.lsh_hash_resolve``), shared by
``tests/test_torch_hash_pass.py`` (the plain version on the CPU against
the JAX package's keys and a dict) and ``tests/test_torch_cuda.py`` (the
CUDA kernel against the plain version on the card).  Imports only numpy
and torch.

A scenario is a list of steps over one batch of points whose keys are
known:

  ("table", cap)          start from an empty table of ``cap`` cells
  ("call", rows, updates) hash the points ``rows`` of the batch after
                          applying ``updates`` (u, 4) int32 ``[key a, key
                          b, table, slot]`` (slot -1: erase)

Every table stays at most half full, as the engine keeps it.
"""

from typing import Dict, List, Tuple

import numpy as np
import torch

CASES = ("empty", "tombstone", "reinsert", "growth", "repeated")
INV_CELL = 1 / 1.5


def pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def batch(n: int, d: int, t: int, seed: int):
    """Points (some sharing cells), offsets and odd mixers as numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * 2).astype(np.float32)
    eta = rng.uniform(0, 1.5, size=t).astype(np.float32)
    mixers = (rng.integers(1, 2**31 - 1, size=(2, t, d)).astype(np.int32)
              | np.int32(1))
    return x, eta, mixers


def _cells(keys: np.ndarray, rows: np.ndarray, slots=None) -> np.ndarray:
    """The distinct (table, key) of ``keys[rows]`` as cells, with slots
    0.. in order (or ``slots``)."""
    t = keys.shape[1]
    k = keys[rows].reshape(-1, 2)
    tab = np.tile(np.arange(t, dtype=np.int32), len(rows))
    trip = np.unique(np.stack([tab, k[:, 0], k[:, 1]], axis=1), axis=0)
    cells = np.empty((len(trip), 4), np.int32)
    cells[:, 0], cells[:, 1], cells[:, 2] = trip[:, 1], trip[:, 2], trip[:, 0]
    cells[:, 3] = np.arange(len(trip)) if slots is None else slots
    return cells


def _erase(cells: np.ndarray) -> np.ndarray:
    out = cells.copy()
    out[:, 3] = -1
    return out


def scenario(case: str, keys: np.ndarray, seed: int) -> List[tuple]:
    """The steps of ``case`` over a batch with ``keys`` (n, t, 2)."""
    n = keys.shape[0]
    rng = np.random.default_rng(seed)
    rows = np.arange(n)
    none = np.zeros((0, 4), np.int32)
    if case == "empty":
        return [("table", 64), ("call", rows, none)]
    if case == "repeated":
        # one point n times: a new key repeated across the batch misses
        # everywhere, then hits everywhere once inserted
        same = np.zeros(n, np.int64)
        return [("table", 64), ("call", same, none),
                ("call", same, _cells(keys, same[:1]))]
    real = _cells(keys, rows[:max(1, n // 2)])
    real[:, 3] = rng.permutation(len(real))
    K = len(real)
    if case == "tombstone":
        # a decoy with the same home cell goes in before each real key,
        # then is erased: every real key is found past a tombstone
        cap = pow2(4 * K)
        decoy = real.copy()
        decoy[:, 0] = (decoy[:, 0].astype(np.int64) + cap).astype(np.int32)
        decoy[:, 1] ^= 1
        decoy[:, 3] = K + np.arange(K)
        return [("table", cap), ("call", rows, decoy),
                ("call", rows, real), ("call", rows, _erase(decoy))]
    if case == "reinsert":
        # erase half, reinsert it with the freed slots reused in another
        # order, then one update that moves a live key to a new slot (an
        # erase and a reinsert netted) and one erase of an absent key
        gone = real[::2]
        back = gone.copy()
        back[:, 3] = rng.permutation(back[:, 3])
        last = np.concatenate([back[:1], _erase(back[:1])])
        last[0, 3] = K + 7
        last[1, 0] ^= 0x5A5A5A5A
        return [("table", pow2(4 * K)), ("call", rows, real),
                ("call", rows, _erase(gone)), ("call", rows, back),
                ("call", rows, last)]
    if case == "growth":
        # a small table, then an emptied one four times larger that takes
        # the whole directory plus new keys in one flush
        a = real[:max(1, K // 2)]
        return [("table", pow2(2 * len(a))), ("call", rows, a),
                ("table", pow2(4 * K)), ("call", rows, real)]
    raise ValueError(case)


def expected(steps: List[tuple], keys: np.ndarray):
    """The slots each call must return, from a dict that takes the same
    updates; and the dict at the end."""
    t = keys.shape[1]
    model: Dict[Tuple[int, int, int], int] = {}
    out = []
    for step in steps:
        if step[0] == "table":
            model = {}
            continue
        _, rows, upd = step
        for a, b, tb, s in upd.tolist():
            if s >= 0:
                model[(tb, a, b)] = s
            else:
                model.pop((tb, a, b), None)
        k = keys[rows]
        out.append(np.array([[model.get((i, int(k[p, i, 0]),
                                         int(k[p, i, 1])), -1)
                              for i in range(t)] for p in range(len(rows))],
                            np.int32).reshape(len(rows), t))
    return out, model


def run(steps: List[tuple], x: torch.Tensor, resolve):
    """Drive ``resolve(points, updates, table)`` through the steps on
    ``x``'s device; returns (each call's output on the CPU, the final
    table)."""
    table, outs = None, []
    for step in steps:
        if step[0] == "table":
            table = torch.full((step[1], 4), -1, dtype=torch.int32,
                               device=x.device)
            continue
        _, rows, upd = step
        idx = torch.from_numpy(np.asarray(rows, np.int64)).to(x.device)
        outs.append(resolve(x[idx].contiguous(),
                            torch.from_numpy(upd).to(x.device),
                            table).cpu().numpy())
    return outs, table


def live(table: torch.Tensor) -> Dict[Tuple[int, int, int], int]:
    """The table's live cells as {(table, key a, key b): slot}; raises if
    one key is held twice."""
    c = table.cpu().numpy()
    c = c[c[:, 3] >= 0]
    out = {(int(r[2]), int(r[0]), int(r[1])): int(r[3]) for r in c}
    assert len(out) == len(c), "a key held twice"
    return out


def past_tombstone(table: torch.Tensor) -> int:
    """Live cells whose probe chain from their home crosses a tombstone."""
    c = table.cpu().numpy()
    mask = len(c) - 1
    n = 0
    for p in np.nonzero(c[:, 3] >= 0)[0]:
        q = int(c[p, 0]) & mask
        while q != p:
            if c[q, 3] == -2:
                n += 1
                break
            q = (q + 1) & mask
    return n
