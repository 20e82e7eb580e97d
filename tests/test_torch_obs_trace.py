"""The port's tracer on the profiler's clock, and the spans of the
trainer, the pipeline and curation, on the CPU.

- A span opened inside a ``record_function`` range under the CPU
  profiler lies within that range's ``[start_ns, end_ns]``, within
  50 µs: both ends of a span are ``time.time_ns()`` reads.
- A span records the OS thread it ran on; a span exported carries the
  keys and values ``repro.obs`` writes, and an export read back by
  either package writes the same summary.
- The null tracer and ``NULL_OBS`` record nothing, and are what the
  trainer, the pipeline and the filter hold by default.
- ``make_train_step(..., obs=)``: ``train.step`` over ``train.forward``,
  ``train.backward``, ``train.optimizer`` in one trace a step; one
  forward and backward a microbatch under accumulation (``mb``).
- ``Pipeline`` / ``CurationFilter(..., obs=)``: ``pipeline.next`` with
  the batch's number, ``curation.filter`` over insert, delete (the
  window's expiries) and labels, and ``engine.comp_rebuild_rows`` from
  the ``soa`` engine in the same registry; keep masks as without spans.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs.trace import Span as JaxSpan  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import (CurationFilter, Pipeline,  # noqa: E402
                                       SyntheticTokenStream)
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.obs import NULL_OBS, NULL_TRACER, Span, Tracer, make_obs  # noqa: E402
from repro_torch.optim import AdamW, warmup_cosine  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402

EXPORT_KEYS = ["name", "trace", "span", "parent", "ts", "dur", "proc", "args"]


def test_a_span_lies_within_the_profilers_range():
    from torch.profiler import ProfilerActivity, profile, record_function

    tr = Tracer("t")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(20):
            with record_function(f"range{i}"):
                with tr.span(f"span{i}"):
                    time.sleep(0.0005)
    ranges = {e.name(): (e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("range")}
    assert len(ranges) == 20 == len(tr.spans)
    for sp in tr.spans:
        a, b = ranges["range" + sp.name[len("span"):]]
        assert a - 50_000 <= sp.start_ns <= sp.end_ns <= b + 50_000
        assert sp.dur_us == pytest.approx((sp.end_ns - sp.start_ns) / 1e3)


def test_spans_carry_their_threads_native_id():
    tr = Tracer("t")
    ids = {}

    def work(name):
        ids[name] = threading.get_native_id()
        with tr.span(name):
            pass

    threads = [threading.Thread(target=work, args=(f"w{i}",))
               for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    work("main")
    assert {sp.name: sp.tid for sp in tr.spans} == ids
    assert len(set(ids.values())) == 4


def test_the_export_is_the_references():
    tr = Tracer("p")
    with tr.span("outer", n=3):
        with tr.span("inner"):
            pass
    for sp in tr.spans:
        d = sp.export()
        assert list(d) == EXPORT_KEYS
        assert d["ts"] == sp.start_ns / 1e3
        assert d["dur"] == (sp.end_ns - sp.start_ns) / 1e3
        assert JaxSpan.from_export(d).export() == d
        back = Span.from_export(d)
        assert back.export() == d and back.tid is None
        assert back.start_ns == round(d["ts"] * 1e3)
    inner, outer = tr.spans
    assert inner.parent_id == outer.span_id
    assert inner.trace_id == outer.trace_id
    assert outer.export()["args"] == {"n": 3}


def test_the_null_tracer_records_nothing():
    with NULL_TRACER.span("x") as sp:
        assert sp is None
    with NULL_OBS.tracer.span("y"):
        pass
    assert NULL_TRACER.spans == [] and NULL_OBS.snapshot()["spans"] == []
    assert make_obs(False) is NULL_OBS
    cf = CurationFilter(d=3, k=4, t=4, eps=0.5, backend="soa")
    pipe = Pipeline(iter([]), curation=cf)
    try:
        assert cf.obs is NULL_OBS and pipe.obs is NULL_OBS
        assert cf.index.obs is NULL_OBS
    finally:
        pipe.close()
        cf.close()


def _tiny_step(obs, accum):
    cfg = dataclasses.replace(get_config("granite-20b").smoke(),
                              dtype="float32", grad_accum=accum)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    opt = AdamW(lr=warmup_cosine(1e-3, 1, 10))
    step = make_train_step(model, opt, obs=obs)
    g = np.random.default_rng(0)
    toks = torch.from_numpy(g.integers(0, cfg.vocab_size, (4, 16)))
    return step, params, opt.init(params), {"tokens": toks,
                                            "labels": toks.roll(-1, 1)}


@pytest.mark.parametrize("accum", [1, 2])
def test_the_train_step_records_its_phases(accum):
    obs = make_obs(True, "trainer")
    step, params, state, batch = _tiny_step(obs, accum)
    for _ in range(2):
        params, state, m = step(params, state, batch)
    spans = obs.tracer.spans
    steps = [sp for sp in spans if sp.name == "train.step"]
    assert len(steps) == 2 and all(sp.parent_id is None for sp in steps)
    for root in steps:
        kids = [sp for sp in spans if sp.parent_id == root.span_id]
        assert all(sp.trace_id == root.trace_id for sp in kids)
        assert [sp.name for sp in kids] == \
            ["train.forward", "train.backward"] * accum + ["train.optimizer"]
        if accum > 1:
            assert [sp.attrs["mb"] for sp in kids[:-1]] == [0, 0, 1, 1]
        for sp in kids:
            assert root.start_ns <= sp.start_ns <= sp.end_ns <= root.end_ns
    assert np.isfinite(float(m["loss"]))


def test_pipeline_and_curation_record_their_spans():
    obs = make_obs(True, "trainer")
    kw = dict(d=16, k=4, t=4, eps=0.6, policy="balance", window=40,
              backend="soa")
    cf, plain = CurationFilter(**kw, obs=obs), CurationFilter(**kw)
    assert cf.index.obs is obs and cf.index.engine.obs is obs
    src = SyntheticTokenStream(vocab_size=64, seq_len=8, batch=8, seed=3)
    pipe = Pipeline(iter(src), curation=cf, prefetch=2, obs=obs)
    try:
        for _ in range(8):
            next(pipe)
    finally:
        pipe.close()
    spans = obs.tracer.spans
    nexts = [sp for sp in spans if sp.name == "pipeline.next"]
    assert [sp.attrs["batch"] for sp in nexts] == list(range(8))
    calls = [sp for sp in spans if sp.name == "curation.filter"]
    assert [sp.attrs["batch"] for sp in calls] == list(range(len(calls)))
    assert all(sp.attrs["rows"] == 8 for sp in calls)
    assert len(calls) == cf.n_calls >= 8
    for c in calls:
        kids = [sp for sp in spans if sp.parent_id == c.span_id]
        assert [sp.name for sp in kids] == \
            ["curation.insert", "curation.delete", "curation.labels"]
        assert all(sp.tid == c.tid != threading.get_native_id()
                   for sp in kids)
    # the window of 40 expires 8 rows a call from the sixth call on
    assert [sp.attrs["n"] for sp in spans if sp.name == "curation.delete"] \
        == [min(8, max(0, 8 * (i + 1) - 40)) for i in range(len(calls))]
    rebuilt = obs.snapshot()["metrics"]["engine.comp_rebuild_rows"]
    assert rebuilt["type"] == "counter" and rebuilt["value"] > 0
    assert "engine.cc_edges" not in obs.snapshot()["metrics"]
    # the same stream through a filter without spans keeps the same rows
    src = SyntheticTokenStream(vocab_size=64, seq_len=8, batch=8, seed=3)
    it = iter(src)
    for _ in range(len(calls)):
        b = next(it)
        kept = plain.filter(b["embeddings"])
    assert plain.n_kept == cf.n_kept and kept.shape == (8,)
    cf.close()
    plain.close()
