"""Atomic, async checkpointing of parameter trees and live cluster indexes.

Mirror of ``repro.checkpoint.manager`` with the same directory layout:

    ckpt_dir/
      step_00000100/
        manifest.json        # keys, shapes, dtypes, specs, extra
        shard_00000.npz      # this host's arrays
      LATEST                 # atomic pointer file
      index_00000100/
        state.npz            # a ClusterIndex snapshot's arrays
        manifest.json        # its ClusterConfig
      LATEST_INDEX

A tree is nested dicts and lists (or tuples) of tensors or numpy arrays;
its keys are the ``/``-joined dict keys and list positions, dict keys in
sorted order, as ``jax.tree_util`` names the reference's leaves.  So a
directory the reference wrote loads here under a template of the same
nesting (numpy leaves give numpy arrays), and index directories
interchange both ways.

  * a tree of DTensors (parameters and optimizer state on a
    ``DeviceMesh``) is saved with each leaf's spec in the manifest, in
    the reference's JSON form (``_spec_to_json``: per dimension null, an
    axis name or a list of names), rebuilt from the placements and the
    mesh's axis names; a plain tensor's spec is ``null``.  Every rank
    takes part in the gather of each leaf, and only ``host_id`` 0
    writes: one ``shard_00000.npz`` of whole arrays, as the reference's
    single-process save writes it, so directories interchange both ways
    (a deliberate departure from the reference's fleet design, where
    every host writes its own shards);
  * :meth:`restore` reshards on load: given ``shardings``, a tree of
    :class:`repro_torch.sharding.axes.NamedSharding` (a mesh and a
    placement list, the counterpart of the reference's
    ``jax.device_put(arr, NamedSharding)``), each array is placed on the
    new mesh whatever mesh saved it; without, on its template leaf's
    (local) device, whole;
  * writes go to a temp dir + atomic rename; LATEST updates last, so a
    crash mid-write never corrupts the restore point;
  * an async writer thread moves serialisation off the training loop.
    :meth:`save` copies every array to host memory before it returns (a
    CPU tensor's ``numpy()`` shares its memory, and the optimizer updates
    parameters in place), so the writer never sees a later step's values.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch


def _flatten_with_paths(tree, prefix: str = "", out=None) -> Dict[str, Any]:
    """``{"a/0/b": leaf}`` for every leaf of ``tree`` (None is no leaf)."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten_with_paths(tree[k], f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten_with_paths(v, f"{prefix}{i}/", out)
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out


def _unflatten(template, values: Dict[str, Any], prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten(v, values, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, values, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    if template is None:
        return None
    return values[prefix[:-1]]


def _spec_to_json(spec):
    """The reference's JSON form of a spec: per dimension None, an axis
    name, or a list of names."""
    if spec is None:
        return None
    return [None if e is None else list(e) if isinstance(e, (tuple, list))
            else str(e) for e in spec]


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that later in-place updates cannot reach."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("CheckpointManager: bfloat16 has no numpy dtype;"
                            " keep parameters in float32")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


class CheckpointManager:
    def __init__(self, directory, keep_n: int = 3, async_write: bool = True,
                 host_id: int = 0):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self.host_id = host_id
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._async = async_write
        self._worker: Optional[threading.Thread] = None
        self._errors: list = []
        self._on_mesh = False
        if async_write:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        """Snapshot to host memory now; write asynchronously.  A DTensor
        leaf is gathered whole on every rank (each rank of its mesh must
        call ``save``), and only ``host_id`` 0 writes."""
        from ..sharding.axes import spec_of

        arrays, specs = {}, {}
        for key, leaf in _flatten_with_paths(tree).items():
            specs[key] = None
            if _is_dtensor(leaf):
                self._on_mesh = True
                specs[key] = _spec_to_json(spec_of(
                    leaf.placements, leaf.device_mesh, leaf.ndim))
                leaf = leaf.full_tensor()
            arrays[key] = _to_host(leaf)
        if self.host_id != 0:
            return
        payload = (step, arrays, specs, extra or {})
        if self._async:
            self._q.put(payload)
        else:
            self._write(payload)

    def wait(self):
        """Until the saves are on disk; after a save of DTensors, on
        every rank of the world (a barrier after host 0's writes)."""
        import torch.distributed as dist

        if self._async:
            self._q.join()
        if self._on_mesh and dist.is_initialized():
            dist.barrier()
        if self._errors:
            raise self._errors[0]

    def _drain(self):
        while True:
            payload = self._q.get()
            try:
                self._write(payload)
            except Exception as e:  # pragma: no cover
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _write(self, payload):
        step, arrays, specs, extra = payload
        name = f"step_{step:08d}"
        tmp = self.dir / f".tmp_{name}_{os.getpid()}"
        tmp.mkdir(parents=True, exist_ok=True)
        np.savez(tmp / f"shard_{self.host_id:05d}.npz", **arrays)
        manifest = {
            "step": step,
            "keys": {k: {"shape": list(a.shape), "dtype": str(a.dtype),
                         "spec": specs[k]} for k, a in arrays.items()},
            "extra": extra,
            "time": time.time(),
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = self.dir / name
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        (self.dir / "LATEST.tmp").write_text(name)
        (self.dir / "LATEST.tmp").rename(self.dir / "LATEST")
        self._gc()

    def _gc(self):
        steps = sorted(p for p in self.dir.glob("step_*") if p.is_dir())
        for p in steps[: -self.keep_n]:
            shutil.rmtree(p, ignore_errors=True)

    # ------------------------------------------------------------------ #
    def latest_step(self) -> Optional[int]:
        f = self.dir / "LATEST"
        if not f.exists():
            return None
        return int(f.read_text().split("_")[1])

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Any = None) -> Any:
        """Restore into ``template``'s tree structure: a tensor leaf gives
        a tensor on that leaf's device (a DTensor's local device), whole,
        in the saved dtype; any other leaf a numpy array.

        ``shardings``: optional matching tree whose leaves are
        :class:`repro_torch.sharding.axes.NamedSharding` (a ``DeviceMesh``
        and a placement list) or None: a leaf with one is placed on its
        mesh as a DTensor, each rank keeping its block — the reference's
        ``jax.device_put(arr, NamedSharding)``, which reshards when the
        mesh changed since the save (elastic restart)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        d = self.dir / f"step_{step:08d}"
        data: Dict[str, np.ndarray] = {}
        for f in sorted(d.glob("shard_*.npz")):
            with np.load(f) as z:
                for k in z.files:
                    data[k] = z[k]
        placed = {} if shardings is None else _flatten_with_paths(shardings)
        out = {}
        for key, leaf in _flatten_with_paths(template).items():
            arr = data[key]
            if placed.get(key) is not None:
                out[key] = placed[key].place(torch.from_numpy(arr))
            elif isinstance(leaf, torch.Tensor):
                dev = leaf.to_local().device if _is_dtensor(leaf) \
                    else leaf.device
                out[key] = torch.from_numpy(arr).to(dev)
            else:
                out[key] = arr
        return _unflatten(template, out)

    def manifest(self, step: Optional[int] = None) -> Dict:
        if step is None:
            step = self.latest_step()
        return json.loads(
            (self.dir / f"step_{step:08d}" / "manifest.json").read_text()
        )

    # ------------------------------------------------------------------ #
    # live cluster-index checkpointing (repro_torch.api snapshots)
    # ------------------------------------------------------------------ #
    def save_index(self, step: int, index) -> None:
        """Persist a ``repro_torch.api.ClusterIndex`` snapshot atomically.

        Layout mirrors the param checkpoints: ``index_<step>/state.npz``
        (fixed-dtype structure arrays, on the host whatever the index's
        device) + ``manifest.json`` (the ClusterConfig), with a temp-dir
        rename and an ``LATEST_INDEX`` pointer updated last — a crash
        mid-write never corrupts the restore point.
        """
        snap = index.snapshot()
        name = f"index_{step:08d}"
        tmp = self.dir / f".tmp_{name}_{os.getpid()}"
        tmp.mkdir(parents=True, exist_ok=True)
        np.savez(tmp / "state.npz", **snap["state"])
        (tmp / "manifest.json").write_text(json.dumps(
            {"step": step, "config": snap["config"], "time": time.time()}
        ))
        final = self.dir / name
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        (self.dir / "LATEST_INDEX.tmp").write_text(name)
        (self.dir / "LATEST_INDEX.tmp").rename(self.dir / "LATEST_INDEX")
        steps = sorted(p for p in self.dir.glob("index_*") if p.is_dir())
        for p in steps[: -self.keep_n]:
            shutil.rmtree(p, ignore_errors=True)

    def latest_index_step(self) -> Optional[int]:
        f = self.dir / "LATEST_INDEX"
        if not f.exists():
            return None
        return int(f.read_text().split("_")[1])

    def restore_index(self, step: Optional[int] = None,
                      device: Optional[str] = None):
        """Rebuild the live ClusterIndex saved by :meth:`save_index` on
        ``device`` (``None``: the backend's default, "cuda" for a device
        backend)."""
        from ..api import restore_index as _restore

        if step is None:
            step = self.latest_index_step()
        if step is None:
            raise FileNotFoundError("no index checkpoint found")
        d = self.dir / f"index_{step:08d}"
        config = json.loads((d / "manifest.json").read_text())["config"]
        with np.load(d / "state.npz") as z:
            state = {k: z[k] for k in z.files}
        return _restore({"config": config, "state": state}, device=device)
