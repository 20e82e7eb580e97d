"""Grid LSH family of Esfandiari–Mirrokni–Zhong (Definition 3).

``h_i(x) = floor((x + eta_i * 1_d) / (2 eps))`` with ``eta_i ~ U[0, 2 eps)``,
one scalar offset per table (the paper shifts every coordinate by the same
``eta``).  Two points share a bucket in table ``i`` iff their integer code
vectors are identical; we key buckets by the raw little-endian bytes of the
code vector (exact — no compression on the host path).

The CUDA kernel behind ``repro_torch.kernels.ops.lsh_hash`` computes 64-bit
mixed keys on the card for batch hashing; :meth:`device_keys_batch` is the
bit-exact host mirror used to validate it and to drive the host update
path.

The family is drawn with numpy ``default_rng(seed)`` in the reference's
order (``eta`` first, then ``mixers``), never with torch's generator, so
the port's keys equal ``repro.core.hashing.GridLSH``'s bit for bit.
"""

from __future__ import annotations

import numpy as np

# finalizer constants (int32 wrap-around; the values of kernels/ref.py)
_MIX_A = np.int32(-1975444243)
_MIX_B = np.int32(-1029739211)


class GridLSH:
    def __init__(self, d: int, eps: float, t: int, seed: int = 0):
        if eps <= 0:
            raise ValueError("eps must be positive")
        self.d = int(d)
        self.eps = float(eps)
        self.t = int(t)
        rng = np.random.default_rng(seed)
        # scalar offset per table, broadcast over coordinates (eta * 1_d)
        self.eta = rng.uniform(0.0, 2.0 * eps, size=t).astype(np.float64)
        self.inv_cell = 1.0 / (2.0 * eps)
        # two families of per-(table, dim) odd int32 multipliers for the
        # on-device mixed-key path (matches the lsh_hash kernel bit-for-bit)
        self.mixers = (
            rng.integers(1, 2**31 - 1, size=(2, t, d), dtype=np.int64).astype(
                np.int32
            )
            | np.int32(1)
        )

    # ------------------------------------------------------------------ #
    # exact (host) path
    # ------------------------------------------------------------------ #
    def codes(self, x: np.ndarray) -> np.ndarray:
        """(d,) -> (t, d) int64 grid codes."""
        return np.floor((x[None, :] + self.eta[:, None]) * self.inv_cell).astype(
            np.int64
        )

    def keys(self, x: np.ndarray) -> list:
        """(d,) -> list of t hashable bucket keys (exact)."""
        c = self.codes(np.asarray(x, dtype=np.float64))
        return [c[i].tobytes() for i in range(self.t)]

    def codes_batch(self, X: np.ndarray, tables: int = None) -> np.ndarray:
        """(n, d) -> (n, t, d) int64 grid codes.

        ``tables=m`` restricts the pass to the first ``m`` tables (the
        shard router only needs table 0), bit-identical to slicing the
        full result."""
        X = np.asarray(X, dtype=np.float64)
        eta = self.eta if tables is None else self.eta[:tables]
        return np.floor(
            (X[:, None, :] + eta[None, :, None]) * self.inv_cell
        ).astype(np.int64)

    def keys_batch(self, X: np.ndarray) -> list:
        """(n, d) -> list over n of lists of t bucket keys."""
        codes = self.codes_batch(X)
        n = codes.shape[0]
        return [[codes[j, i].tobytes() for i in range(self.t)] for j in range(n)]

    # ------------------------------------------------------------------ #
    # mixed-key path (mirrors the lsh_hash kernel bit-for-bit)
    # ------------------------------------------------------------------ #
    @staticmethod
    def _avalanche(h: np.ndarray) -> np.ndarray:
        def lsr(v, s):  # logical shift right on int32
            return (v.view(np.uint32) >> np.uint32(s)).view(np.int32)

        h = h ^ lsr(h, 16)
        h = (h * _MIX_A).astype(np.int32)
        h = h ^ lsr(h, 13)
        h = (h * _MIX_B).astype(np.int32)
        h = h ^ lsr(h, 16)
        return h

    def device_keys_batch(self, X: np.ndarray, tables: int = None) -> np.ndarray:
        """(n, d) -> (n, t, 2) int32 keys; bit-exact numpy mirror of the
        lsh_hash kernel (f32 grid quantisation + two int32 universal mixes).

        Used to validate the kernel and as the host fallback for the
        batched update path.  Spurious cross-code collisions ~ 2^-64.
        ``tables=m`` restricts the pass to the first ``m`` tables
        (elementwise per table, so bit-identical to slicing).
        """
        X32 = np.asarray(X, dtype=np.float32)
        eta = self.eta if tables is None else self.eta[:tables]
        mixers = self.mixers if tables is None else self.mixers[:, :tables]
        codes = np.floor(
            (X32[:, None, :] + eta.astype(np.float32)[None, :, None])
            * np.float32(self.inv_cell)
        ).astype(np.int32)  # (n, t, d)
        with np.errstate(over="ignore"):
            acc_a = (codes * mixers[0][None]).sum(axis=-1, dtype=np.int32)
            acc_b = (codes * mixers[1][None]).sum(axis=-1, dtype=np.int32)
            out = np.stack(
                [self._avalanche(acc_a), self._avalanche(acc_b)], axis=-1
            )
        return out
