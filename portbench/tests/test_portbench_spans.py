"""The program's spans joined with the device trace (``portbench/spans.py``)
and the run that reads them (``portbench/phases.py``).

- Synthetic traces: a device operation is charged by where and when it
  was launched, not by when it ran; the autograd engine's thread is
  charged by the trainer's spans; a launch from the prefetch thread (by
  the profiler's name for it) to curation; an operation with no launch
  to ``other``, counted.  The idle intervals under ``curation.filter``.
- With nothing to read, every reading is None.
- A tiny run on the CPU with spans on: one ``train.step`` a step taken,
  ``curation.filter`` and ``pipeline.next`` within 1 ms of the
  harness's ``curation_batch_ms`` and ``curation_wait_ms``; the
  harness's own session holds ``NULL_OBS`` and records nothing.
- On the card (skips here): the phases' device time adds up to the
  trace's busy time within 1%.
"""

import sys
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench import spans  # noqa: E402
from portbench_tiny import CELLS, one_thread, tiny  # noqa: E402
from repro_torch.obs import Span  # noqa: E402

_one_thread = pytest.fixture(autouse=True)(one_thread)

TRAINER, AUTOGRAD, PREFETCH = 100, 200, 300


class _Thread:
    def __init__(self, ident, native_id):
        self.ident, self.native_id = ident, native_id


#: the profiler's names for two threads it did not register: the low 32
#: bits of ``pthread_self()``, signed
ALIASES = spans.thread_aliases([_Thread(0x7F12_3456_7000, PREFETCH),
                                _Thread(0x7F12_B4A0_06C0, PREFETCH)])


def _span(name, a, b, tid, parent=None):
    sp = Span(name, 1, id((name, a)), parent, "t")
    sp.start_ns, sp.end_ns, sp.tid = a, b, tid
    return sp


def _step_spans():
    """One step 0-100: forward 10-40, backward 40-70, optimizer 70-95 on
    the trainer; a filter 20-60 (labels 45-55) on the prefetch thread."""
    step = _span("train.step", 0, 100, TRAINER)
    filt = _span("curation.filter", 20, 60, PREFETCH)
    return [_span("train.forward", 10, 40, TRAINER, step.span_id),
            _span("train.backward", 40, 70, TRAINER, step.span_id),
            _span("train.optimizer", 70, 95, TRAINER, step.span_id), step,
            _span("curation.labels", 45, 55, PREFETCH, filt.span_id), filt]


CASES = {
    # launched in the forward, run during the backward
    "forward_launch_runs_later": ((50, 60, 1), (30, TRAINER), "forward"),
    "autograd_thread": ((50, 60, 1), (45, AUTOGRAD), "backward"),
    "prefetch_thread": ((30, 35, 1), (25, 0x3456_7000), "curation"),
    "prefetch_thread_high_bit": ((30, 35, 1), (25, 0xB4A0_06C0 - 2**32),
                                 "curation"),
    "trainer_between_phases": ((96, 99, 1), (96, TRAINER), "other"),
    "unmatched": ((10, 20, 2), (15, TRAINER), "other"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_an_op_is_charged_where_it_was_launched(case):
    op, launch, want = CASES[case]
    launches = {1: launch}
    ph = spans.phase_device_s([op], launches, _step_spans(), (0, 100),
                              ALIASES)
    assert ph.device_s[want] == pytest.approx((op[1] - op[0]) / 1e9)
    assert sum(ph.device_s.values()) == ph.device_s[want]
    assert ph.unmatched == (case == "unmatched")
    assert ph.steps == 1


def test_the_aliases_are_the_profilers_signed_ids():
    assert ALIASES == {0x3456_7000: PREFETCH,
                       0xB4A0_06C0 - 2**32: PREFETCH}
    assert spans.thread_aliases([_Thread(None, None)]) == {}


def test_an_op_is_clipped_to_the_window():
    ph = spans.phase_device_s([(90, 130, 1)], {1: (80, TRAINER)},
                              _step_spans(), (0, 100))
    assert ph.device_s["optimizer"] == pytest.approx(10 / 1e9)


def test_idle_under_curation_is_found():
    # busy 0-30 and 40-100: idle 30-40, of which 30-40 under the filter
    # (20-60); idle 100-120 is outside any filter
    ops = [(0, 30, 1), (40, 100, 2), (50, 70, 3)]
    idle = spans.idle_under(ops, _step_spans(), (0, 120))
    assert idle == [(30, 40)]
    phases = spans.Phases({**dict.fromkeys(spans.PHASES, 0.0),
                           "forward": 1e-9}, 0, 1)
    r = spans.readings(phases, idle, (0, 120), _step_spans())
    assert r["curation_idle_pct"] == pytest.approx(100 * 10 / 120)
    assert r["curation_labels_ms"] == pytest.approx(10 / 1e6)
    assert r["forward_device_ms"] == pytest.approx(1e-6)


def test_readings_with_nothing_to_read_are_none():
    empty = spans.readings(None, None, (0, 0), [], None)
    assert set(empty) == {"forward_device_ms", "backward_device_ms",
                          "optimizer_device_ms", "curation_idle_pct",
                          "curation_labels_ms",
                          "curation_rebuild_rows_per_point"}
    assert all(v is None for v in empty.values())
    no_ops = spans.phase_device_s([], {}, _step_spans(), (0, 100))
    r = spans.readings(no_ops, [], (0, 100), [], (5, (0, 100)))
    assert all(v is None for v in r.values())
    rows = spans.readings(None, None, (0, 100), _step_spans(),
                          (40, (0, 100)))
    assert rows["curation_rebuild_rows_per_point"] is None  # no rows attr


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_tiny_run_with_spans_agrees_with_the_harness(cell_name):
    from portbench import phases

    cell, kw, _ = tiny(cell_name)
    out = phases.run(cell, 2**31 + 77, 2, 0.5, "cpu", **kw)
    for row in out["cost"]["on"]:
        sp = row["spans"]
        assert sp["train_step_n"] == row["steps"] >= 1
        assert abs(sp["curation_filter_ms"]
                   - row["curation_batch_ms"]) < 1.0
        assert abs(sp["pipeline_next_ms"] - row["curation_wait_ms"]) < 1.0
    tr = out["traced"]
    assert tr["steps"] == 2 and tr["device_ops"] == 0
    r = tr["readings"]
    assert r["forward_device_ms"] is None and r["curation_idle_pct"] is None
    assert r["curation_labels_ms"] > 0


def test_the_harness_hands_the_program_no_handle():
    from portbench.harness import Session
    from repro_torch.obs import NULL_OBS, NULL_TRACER

    cell, kw, _ = tiny(CELLS[0])
    s = Session(cell, 11, "cpu", **kw)
    s.setup()
    try:
        s.one_step()
        assert s.pipe.obs is NULL_OBS and s.curation.inner.obs is NULL_OBS
        assert s.curation.inner.index.obs is NULL_OBS
        assert NULL_TRACER.spans == []
    finally:
        s.close_program()


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_the_phases_add_up_to_the_busy_time_on_the_card(card, cell_name):
    from portbench import phases

    cell, kw, _ = tiny(cell_name)
    t0 = time.perf_counter()
    tr = phases.run(cell, 4242, 3, 0.0, "cuda", **kw)["traced"]
    assert time.perf_counter() - t0 < 600
    assert tr["busy_s"] > 0 and tr["steps"] == 3
    assert tr["phase_sum_s"] == pytest.approx(tr["busy_s"], rel=0.01)
    for p in ("forward", "backward", "optimizer"):
        assert tr["phase_device_s"][p] > 0
    assert tr["readings"]["backward_device_ms"] is not None
