"""Batched update path: one hash call a batch + host structure, ported
from ``repro.core.batched``.

The paper processes a batch of B updates as B sequential O(polylog)
operations, each paying O(t·d) hashing on the host.  Here the hashing of
the whole batch is one ``lsh_hash`` call (``use_device``): the batch goes
up as float32, the kernel computes the (B, t, 2) int32 keys on the card,
and only the keys come back to the host, which then performs the
pointer updates.  The clustering is identical (H is invariant to update
order and to the key representation — §4.2); the throughput is not.

``BatchedDynamicDBSCAN`` shares all the machinery of ``DynamicDBSCAN`` but
keys every bucket by the kernel's mixed keys, so single-point and batch
updates interoperate.  ``use_device=False`` hashes with the host numpy
mirror of the kernel (``GridLSH.device_keys_batch``, backend
``batched``); ``use_device=True`` calls ``ops.lsh_hash`` on ``device``
(backend ``batched-device``): the CUDA kernel on ``"cuda"``, which
raises when it cannot build or launch, its plain PyTorch version on
``"cpu"``.  Both give the same keys bit for bit.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..kernels import ops
from .dynamic_dbscan import DynamicDBSCAN, check_unique_ids, claim_index
from .hashing import GridLSH


class BatchedDynamicDBSCAN(DynamicDBSCAN):
    def __init__(self, d, k, t, eps, seed: int = 0, use_device: bool = False,
                 attach_orphans: bool = True, lsh: Optional[GridLSH] = None,
                 repair: str = "exact", device: str = "cuda"):
        super().__init__(d, k, t, eps, seed=seed,
                         attach_orphans=attach_orphans, lsh=lsh, repair=repair)
        self.use_device = bool(use_device)
        # the device the hash call runs on (unused when use_device is
        # off); "cuda" needs a card and a kernel library that builds
        self.device = torch.device(device)
        if self.use_device:
            if self.device.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        "use_device on 'cuda' but CUDA is not available; "
                        "pass device='cpu' to run the plain kernel")
                ops.ensure_built()
            elif self.device.type != "cpu":
                raise ValueError(f"unsupported device {self.device}")
            self._eta_dev = torch.from_numpy(
                self.lsh.eta.astype(np.float32)).to(self.device)
            self._mix_dev = torch.from_numpy(
                np.ascontiguousarray(self.lsh.mixers)).to(self.device)

    # key space: kernel mixed keys (int32 pairs) instead of exact codes
    def _keys_of_batch(self, X: np.ndarray) -> List[list]:
        X = np.asarray(X, dtype=np.float32)
        if self.use_device:
            keys = self._device_hash(X)
        else:
            keys = self.lsh.device_keys_batch(X)
        return [
            [keys[j, i].tobytes() for i in range(self.t)]
            for j in range(X.shape[0])
        ]

    def _device_hash(self, X: np.ndarray) -> np.ndarray:
        """(B, d) float32 -> (B, t, 2) int32 keys: one upload of the
        batch, one ``ops.lsh_hash`` call, one synchronising download
        (through pinned memory on "cuda")."""
        x = torch.from_numpy(np.ascontiguousarray(X))
        on_card = self.device.type == "cuda"
        if on_card:
            x = x.pin_memory()
        keys = ops.lsh_hash(x.to(self.device, non_blocking=True),
                            self._eta_dev, self._mix_dev,
                            inv_cell=self.lsh.inv_cell)
        out = torch.empty(keys.shape, dtype=torch.int32, pin_memory=on_card)
        out.copy_(keys, non_blocking=True)
        if on_card:
            torch.cuda.current_stream(self.device).synchronize()
        return out.numpy()

    def add_point(self, x: np.ndarray, idx: Optional[int] = None) -> int:
        return self.add_batch(
            np.asarray(x, dtype=np.float64)[None], ids=[idx]
        )[0]

    def add_batch(self, X: np.ndarray,
                  ids: Optional[Sequence[Optional[int]]] = None) -> List[int]:
        """Hash the whole batch in one kernel call, then apply updates.

        ``ids`` optionally pins explicit indices (None entries auto-assign),
        mirroring the parent class's ``add_point(x, idx)`` contract.
        """
        X = np.asarray(X, dtype=np.float64)
        if X.ndim != 2 or X.shape[1] != self.d:
            raise ValueError(f"batch shape {X.shape} != (n, {self.d})")
        if ids is not None and len(ids) != X.shape[0]:
            raise ValueError("ids length must match batch size")
        keys = self._keys_of_batch(X)
        out = []
        for j in range(X.shape[0]):
            idx, self._next_idx = claim_index(
                self.points, self._next_idx,
                ids[j] if ids is not None else None,
            )
            out.append(self._add_with_keys(X[j], keys[j], idx))
        # batch boundary: squash the change feed (drain_deltas) so a
        # B-point run contributes O(touched ids), not O(B·t), entries
        self._compact_journal()
        return out

    def delete_batch(self, ids: Sequence[int]) -> None:
        check_unique_ids(ids)
        for i in ids:
            self.delete_point(i)
        self._compact_journal()
