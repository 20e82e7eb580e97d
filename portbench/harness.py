"""One run of a cell: the program's set-up, its measured window, its
readings, then the reference's.

The program under test is ``repro_torch``'s trainer as
``repro_torch.launch.train.train`` assembles it, without checkpoints or
the heartbeat: ``make_train_step(model, AdamW, grad_accum)`` fed by
``Pipeline(stream, curation=CurationFilter(..., backend="soa-device"))``.
The benchmark gives it the stream (:class:`.inputs.TokenStream`) and the
weights (:func:`.inputs.make_params`), both from the seed, and wraps the
curation filter in a clock (:class:`TimedCuration`).

Set-up builds the one step object and drives it through the traffic's
``checked_steps`` first steps, reading what the check compares: each
step's loss, every leaf's first gradient from the optimizer's first
moment after step 1, and every leaf's change after the last of them.
The window then drives the same object for ``seconds``; the reference
runs once the window has closed and the program's state is freed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from . import counts, devtrace, inputs
from .manifest import Cell
from .reference import clustering as ref_clustering
from .reference import lm as ref_lm


class TimedCuration:
    """The program's ``CurationFilter`` with the host clock around each
    ``filter`` call, keeping each call's inputs and keep mask."""

    def __init__(self, inner):
        self.inner = inner
        self.calls: List[Dict[str, Any]] = []

    def filter(self, embeddings: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        keep = self.inner.filter(embeddings)
        t1 = time.perf_counter()
        self.calls.append({"t0": t0, "t1": t1,
                           "embeddings": np.array(embeddings, copy=True),
                           "keep": np.array(keep, dtype=bool, copy=True)})
        return keep

    def close(self) -> None:
        self.inner.close()


@dataclasses.dataclass
class RunRecord:
    """What the per-layer metrics read (``metrics/<name>.py``)."""
    steps: List[Dict[str, float]]
    window_start: float
    window_end: float
    curation_calls: List[Dict[str, float]]
    tokens_per_step: int
    flops_per_step: float
    flash_bound_s: float
    peak_flops: float
    trace: Optional[devtrace.TraceSummary] = None


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Session:
    """``cell`` at ``seed`` on ``device``.  ``fault`` (tests and the
    calibration only) breaks the program underneath: a callable
    ``fault(session)`` run after the program is built."""

    def __init__(self, cell: Cell, seed: int, device: str = "cuda",
                 arch: Optional[Dict[str, Any]] = None,
                 traffic: Optional[Dict[str, Any]] = None,
                 fault: Optional[Callable] = None):
        self.cell = cell
        self.seed = int(seed)
        self.device = device
        self.arch = dict(arch or cell.config["arch"])
        self.traffic = dict(traffic or cell.traffic)
        self.fault = fault
        self.readings: Dict[str, Any] = {}

    # ------------------------------------------------------------------ #
    # the program
    # ------------------------------------------------------------------ #
    def build(self) -> None:
        from repro_torch.configs.base import ArchConfig
        from repro_torch.data.pipeline import CurationFilter, Pipeline
        from repro_torch.models.registry import build_model
        from repro_torch.optim import AdamW, warmup_cosine
        from repro_torch.training import make_train_step

        tr, opt = self.traffic, self.traffic["optimizer"]
        self.cfg = ArchConfig(name=self.cell.config["name"], **self.arch)
        self.model = build_model(self.cfg, device=self.device)
        self.params = inputs.make_params(self.arch, self.seed, self.device)
        self.opt = AdamW(lr=warmup_cosine(opt["lr"], opt["warmup_steps"],
                                          opt["total_steps"]),
                         b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
                         weight_decay=opt["weight_decay"],
                         clip_norm=opt["clip_norm"])
        self.opt_state = self.opt.init(self.params)
        self.step_fn = make_train_step(self.model, self.opt,
                                       grad_accum=tr["grad_accum"])
        cur = tr["curation"]
        self.curation = TimedCuration(CurationFilter(
            d=tr["stream"]["embed_dim"], k=cur["k"], t=cur["t"],
            eps=cur["eps"], policy=cur["policy"], window=cur["window"],
            max_per_cluster_frac=cur["max_per_cluster_frac"],
            seed=self.curation_seed, backend=cur["backend"],
            device=self.device))
        if self.fault is not None:
            self.fault(self)
        self.pipe = Pipeline(iter(self.stream()), curation=self.curation,
                             prefetch=tr["prefetch"])

    @property
    def curation_seed(self) -> int:
        return self.seed % (2**31)

    def stream(self) -> inputs.TokenStream:
        tr = self.traffic
        return inputs.TokenStream(self.arch["vocab_size"], tr["seq"],
                                  tr["batch"], self.seed,
                                  n_topics=tr["stream"]["n_topics"],
                                  embed_dim=tr["stream"]["embed_dim"])

    def one_step(self) -> float:
        t0 = time.perf_counter()
        batch = next(self.pipe)
        self.last_wait_s = time.perf_counter() - t0
        tb = {k: torch.from_numpy(batch[k]).to(self.device, torch.long)
              for k in ("tokens", "labels")}
        self.params, self.opt_state, m = self.step_fn(
            self.params, self.opt_state, tb)
        return float(m["loss"])

    def setup(self) -> None:
        """Build, then the checked steps, reading what the check needs;
        returns with the prefetch queue full."""
        t = [time.perf_counter()]
        self.build()
        _sync(self.device)
        t.append(time.perf_counter())
        b1 = self.traffic["optimizer"]["b1"]
        losses = []
        for i in range(self.traffic["checked_steps"]):
            losses.append(self.one_step())
            t.append(time.perf_counter())
            if i == 0:
                first_wait = self.last_wait_s
                m1 = inputs.leaf_norms(self.opt_state["m"], self.arch)
                first = {k: v / (1 - b1) for k, v in m1.items()}
                t[-1] = time.perf_counter()
        self.readings = {
            "losses": losses, "first_grad": first,
            "update": inputs.initial_leaf_norms(self.arch, self.seed,
                                                self.params, self.device)}
        t.append(time.perf_counter())
        deadline = time.perf_counter() + 60.0
        while (not self.pipe.q.full()
               and time.perf_counter() < deadline):
            time.sleep(0.005)
        _sync(self.device)
        t.append(time.perf_counter())
        d = np.diff(t).tolist()
        self.setup_parts = {"build_s": d[0], "steps_s": d[1:-2],
                            "first_batch_wait_s": first_wait,
                            "readings_s": d[-2], "queue_s": d[-1]}

    def window(self, seconds: float, trace: bool) -> RunRecord:
        """Steps until ``seconds`` have passed since the first began;
        under ``trace``, the traffic's ``trace_steps`` steps from
        ``trace_from_step`` on are profiled."""
        tr = self.traffic
        t_from, t_n = tr["trace_from_step"], tr["trace_steps"]
        prof = traced = None
        label = devtrace.label if trace else (
            lambda name: contextlib.nullcontext())
        steps: List[Dict[str, float]] = []
        t_start = time.perf_counter()
        i = 0
        while True:
            if trace and i == t_from:
                prof = devtrace.start()
            t0 = time.perf_counter()
            with label("next_batch"):
                batch = next(self.pipe)
            t1 = time.perf_counter()
            with label("to_device"):
                tb = {k: torch.from_numpy(batch[k]).to(self.device,
                                                       torch.long)
                      for k in ("tokens", "labels")}
            with label("step"):
                self.params, self.opt_state, m = self.step_fn(
                    self.params, self.opt_state, tb)
            with label("loss_readback"):
                loss = float(m["loss"])
            t2 = time.perf_counter()
            steps.append({"t_wait": t0, "t_batch": t1, "t_end": t2,
                          "loss": loss, "traced": prof is not None})
            i += 1
            if prof is not None and i == t_from + t_n:
                devtrace.stop(prof)
                traced, prof = prof, None
            if t2 - t_start >= seconds:
                break
        if prof is not None:
            devtrace.stop(prof)
            traced = prof
        t_end = steps[-1]["t_end"]
        a = self.arch
        return RunRecord(
            steps=steps, window_start=t_start, window_end=t_end,
            curation_calls=[
                {"t0": c["t0"], "t1": c["t1"]} for c in self.curation.calls
                if t_start <= c["t0"] <= t_end],
            tokens_per_step=tr["batch"] * tr["seq"],
            flops_per_step=counts.model_flops(a, tr["batch"], tr["seq"]),
            flash_bound_s=counts.flash_bound_s(a, tr["batch"], tr["seq"]),
            peak_flops=counts.PEAK_BF16_FLOPS,
            trace=None if traced is None else devtrace.summarize(traced))

    def close_program(self) -> None:
        """Stop the pipeline, read the window's final partition, free the
        program's state."""
        self.pipe.close()
        self.readings["partition"] = self.curation.inner.index.labels()
        self.readings["keeps"] = [c["keep"] for c in self.curation.calls]
        self.curation.close()
        for name in ("params", "opt_state", "step_fn", "model", "pipe"):
            setattr(self, name, None)
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------ #
    # the reference
    # ------------------------------------------------------------------ #
    def reference_curation(self):
        """The reference's keep mask of every batch the program filtered
        (from the same embeddings) and its final partition."""
        tr, cur = self.traffic, self.traffic["curation"]
        plain = ref_clustering.PlainCuration(
            d=tr["stream"]["embed_dim"], k=cur["k"], t=cur["t"],
            eps=cur["eps"], seed=self.curation_seed, window=cur["window"],
            max_per_cluster_frac=cur["max_per_cluster_frac"],
            policy=cur["policy"])
        keeps = [plain.filter(c["embeddings"]) for c in self.curation.calls]
        lab = plain.labels()
        return keeps, {i: int(v) for i, v in enumerate(lab.tolist())}

    def reference_batches(self, keeps) -> List[Dict[str, torch.Tensor]]:
        """The checked steps' batches as the reference's keep masks select
        them: a batch whose mask keeps nothing is skipped, a short one
        refilled by repeating its kept rows in order."""
        out = []
        stream = iter(self.stream())
        for keep in keeps:
            batch = next(stream)
            if len(out) == self.traffic["checked_steps"]:
                break
            idx = np.flatnonzero(keep)
            if idx.size == 0:
                continue
            fill = np.resize(idx, batch["tokens"].shape[0])
            out.append({k: torch.from_numpy(batch[k][fill]).to(
                self.device, torch.long) for k in ("tokens", "labels")})
        return out

    def reference(self, numerics: str = "f32") -> Dict[str, Any]:
        keeps, partition = self.reference_curation()
        batches = self.reference_batches(keeps)
        if torch.device(self.device).type == "cuda":
            ref_lm.precise()
        params = inputs.make_params(self.arch, self.seed, self.device)
        res = ref_lm.train(params, self.arch, batches,
                           self.traffic["optimizer"], numerics)
        res["update"] = inputs.initial_leaf_norms(self.arch, self.seed,
                                                  params, self.device)
        res["keeps"], res["partition"] = keeps, partition
        del params
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        return res
