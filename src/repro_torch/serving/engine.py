"""Batched serving engine: prefill + decode over a shared KV cache, with
optional dynamic-DBSCAN request clustering.

Mirror of ``repro.serving.engine``.  Continuous-batching-style loop for
a fixed batch width B:
  * incoming requests queue up; free slots are filled by prefilling the
    request's prompt into the slot's cache region;
  * one fused decode step advances every active slot by a token;
  * finished slots (EOS / max_len) are released.

Request clustering (the paper's technique on the serving side): request
embeddings are clustered online by an index of
:mod:`repro_torch.api`, built on the model's device; the scheduler
batches same-cluster requests together and expires old requests from
the window — the paper's insert+delete workload.

The decode step is a plain call under ``torch.inference_mode()`` (the
reference jits it).  ``cluster_backend`` keeps the reference's default,
``"batched"`` (host); the engine hands its device only to a device
backend (``repro_torch.api.DEVICE_BACKENDS``, e.g. ``batched-device``,
``soa-device``, and ``sharded`` over one of them when
``cluster_shards > 1``) and ``None`` to a host backend, ``tiered``
(``cluster_tier``) among them.

``mesh=`` (a ``DeviceMesh``; the reference's ``mesh`` argument) serves a
model placed on it (parameters from ``init(seed, mesh=mesh)`` or
``models.registry.shard_params``): the caches are laid out by their
logical axes and every decode step runs the models' mesh path.  Every
rank runs this same host loop — scheduling, prefill of freed slots, the
request clustering — on the same requests; the logits are gathered
whole on every rank (``full_tensor()``), so every rank picks the same
greedy tokens and keeps the same schedule.  Rank 0 returns and reports;
the others run along.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..api import ClusterConfig, build_index
from ..api.registry import runs_on_device
from ..models.registry import ModelAPI
from ..obs import NULL_OBS, Obs


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (len,) int32
    max_new_tokens: int = 16
    embedding: Optional[np.ndarray] = None
    out_tokens: Optional[List[int]] = None
    cluster: Optional[int] = None
    # engine-managed state
    _cidx: Optional[int] = None   # clusterer handle of this request's embedding
    _next: Optional[int] = None   # next token to feed the fused decode step


class ServingEngine:
    def __init__(self, model: ModelAPI, params, batch: int, kv_len: int,
                 eos_id: int = -1, cluster_requests: bool = False,
                 embed_dim: int = 8,
                 cluster_backend: str = "batched",
                 cluster_shards: int = 1,
                 cluster_workers: int = 0,
                 cluster_transport: str = "local",
                 cluster_replicas: int = 0,
                 cluster_tier: Optional[float] = None,
                 obs: Obs = NULL_OBS, mesh=None):
        self.model = model
        self.device = model.device
        self.mesh = mesh
        # serving telemetry: per-op latency + scheduler state gauges.
        # Passing a live Obs also turns the clusterer's own obs knob on.
        self.obs = obs
        self._h_submit_us = obs.histogram("serving.submit_us")
        self._h_step_us = obs.histogram("serving.step_us")
        self._g_queue = obs.gauge("serving.queue_depth")
        self._g_active = obs.gauge("serving.active_slots")
        self.params = params
        self.B = batch
        self.kv_len = kv_len
        self.eos = eos_id
        self._on_mesh = {} if mesh is None else {"mesh": mesh}
        self.caches = model.decode_init(batch, kv_len, **self._on_mesh)
        self.slots: List[Optional[Request]] = [None] * batch
        self.slot_pos = np.zeros(batch, dtype=np.int64)
        self.queue: List[Request] = []
        self.done: Dict[int, Request] = {}
        # cluster_tier=<rate> switches to tiered serving
        # (repro_torch.tiered): a sampled-core front tier at that
        # sample_rate labels requests at once while the exact tier
        # verifies on a thread; both run on the host, so the index gets
        # no device, and close() stops its verifier.  cluster_shards > 1
        # wraps the backend into "sharded" (repro_torch.shard), whose
        # shards run where the backend would (the model's device for a
        # device backend) and are reached by cluster_transport
        if cluster_tier is not None:
            cluster_backend = "tiered"
        self.clusterer = None
        if cluster_requests:
            ccfg = ClusterConfig(
                d=embed_dim, k=4, t=6, eps=0.6, backend=cluster_backend,
                workers=cluster_workers, transport=cluster_transport,
                replicas=cluster_replicas,
                sample_rate=(cluster_tier if cluster_tier is not None
                             else 1.0),
                obs=obs.enabled).with_shards(cluster_shards)
            # the model's device only for a backend that runs on one; a
            # host backend gets None (an explicit device would raise)
            self.clusterer = build_index(
                ccfg, device=(str(self.device) if runs_on_device(ccfg)
                              else None))
        # sliding admission window: evicted at the head on every submit
        # past capacity
        self._req_window: Deque[int] = collections.deque()

    # ------------------------------------------------------------------ #
    def _step(self, tokens: np.ndarray, mask: np.ndarray):
        """One fused decode step of every row (``mask``: active rows);
        advances ``self.caches`` and returns the logits."""
        dev = self.device
        with torch.inference_mode():
            logits, self.caches = self.model.decode_step(
                self.params, self.caches, torch.from_numpy(tokens).to(dev),
                torch.from_numpy(self.slot_pos.astype(np.int32)).to(dev),
                torch.from_numpy(mask).to(dev), **self._on_mesh)
            if self.mesh is not None:
                logits = logits.full_tensor()
        return logits

    def submit(self, req: Request) -> None:
        with self.obs.tracer.span("serving.submit", rid=req.rid), \
                self._h_submit_us.timer():
            self._submit_impl(req)
        self._g_queue.set(len(self.queue))

    def _submit_impl(self, req: Request) -> None:
        req.out_tokens = []
        if self.clusterer is not None and req.embedding is not None:
            idx = self.clusterer.insert_batch(req.embedding[None])[0]
            req.cluster = self.clusterer.label(idx)
            req._cidx = idx
            self._req_window.append(idx)
            if len(self._req_window) > 4 * self.B:
                self.clusterer.delete(self._req_window.popleft())
            # a non-empty change feed re-labels the requests scheduling
            # reads: the queue and the active slots
            if self.clusterer.drain_deltas() != []:
                for r in (*self.queue, *filter(None, self.slots)):
                    i = r._cidx
                    if i is not None and i in self.clusterer:
                        r.cluster = self.clusterer.label(i)
        self.queue.append(req)

    def _schedule(self) -> None:
        """Fill free slots; prefer same-cluster requests (locality)."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free or not self.queue:
            return
        if self.clusterer is not None:
            active = [s.cluster for s in self.slots if s is not None]
            self.queue.sort(
                key=lambda r: (r.cluster not in active, r.rid)
            )
        for i in free:
            if not self.queue:
                break
            req = self.queue.pop(0)
            self._prefill(i, req)

    def _prefill(self, slot: int, req: Request) -> None:
        """Teacher-force the prompt through the decode path one token at a
        time (simple and exact, as in the reference)."""
        self.slots[slot] = req
        self.slot_pos[slot] = 0
        for tok in req.prompt[:-1]:
            self._advance_slot(slot, int(tok))
        req._next = int(req.prompt[-1])

    def _advance_slot(self, slot: int, token: int) -> None:
        tokens = np.zeros((self.B, 1), dtype=np.int32)
        tokens[slot, 0] = token
        mask = np.zeros((self.B,), dtype=bool)
        mask[slot] = True
        self._step(tokens, mask)
        self.slot_pos[slot] += 1

    # ------------------------------------------------------------------ #
    def step(self) -> int:
        """One fused decode step for all active slots; returns #active."""
        with self._h_step_us.timer():
            n = self._step_impl()
        self._g_queue.set(len(self.queue))
        self._g_active.set(n)
        return n

    def _step_impl(self) -> int:
        self._schedule()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return 0
        tokens = np.zeros((self.B, 1), dtype=np.int32)
        mask = np.zeros((self.B,), dtype=bool)
        for i in active:
            tokens[i, 0] = self.slots[i]._next
            mask[i] = True
        logits = self._step(tokens, mask)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for i in active:
            req = self.slots[i]
            tok = int(nxt[i])
            req.out_tokens.append(tok)
            req._next = tok
            self.slot_pos[i] += 1
            if (tok == self.eos or len(req.out_tokens) >= req.max_new_tokens
                    or self.slot_pos[i] >= self.kv_len - 1):
                self.done[req.rid] = req
                self.slots[i] = None
        return len(active)

    def run_until_drained(self, max_steps: int = 10_000) -> Dict[int, Request]:
        for _ in range(max_steps):
            if not self.queue and all(s is None for s in self.slots):
                break
            self.step()
        return self.done

    def close(self) -> None:
        """Release the clusterer's external resources (the tiered index's
        verifier thread, a sharded index's pool and workers)."""
        if self.clusterer is not None:
            self.clusterer.close()
