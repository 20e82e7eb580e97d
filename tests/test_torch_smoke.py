"""``chip_smoke.py`` on the CPU: its main path runs end to end at a tiny
size with the kernels' plain versions (the port's ``soa-device`` on
``device="cpu"`` against its host ``soa`` engine, labels and deltas
equal), so does its baselines path (the host baselines, then the
eps-ball counts through ``ops`` on the CPU), so does its LM path
(gemma3-27b's smoke config at the phase's depth: prefill, the attention
checks, prefill vs decode, clustered serving), so does its training phase (index checkpoints,
curation, the trainer and its protocol at granite-20b's smoke config),
so does its families phase (the six archs of the moe, vlm, ssm, hybrid
and audio families at their smoke configs, and ``launch.serve``'s
defaults), so does its cells phase (every cell of the reference's grid
that it runs, at the smoke configs), so does its mesh analysis phase
(13: the published configurations of phases 11 and 12 analysed on
``meta`` in a child process, whose gates refuse a failed run, a (1, 1)
run unlike the one-card analysis and a multi-card mesh that sends
nothing), so does its examples phase (14: ``python -m
repro_torch.analysis`` in a child process, then the five
``examples/torch_*.py``, the clustering ones twice on the CPU here,
whose gates refuse a finding and a card run that prints other numbers
than the CPU run),
its attention bound counts the unmasked pairs, and the script itself
refuses to run without a CUDA device."""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def test_main_path_runs_on_cpu():
    metrics, last = chip_smoke.run_main_path(3000, "cpu")
    assert metrics["points"] == 3000 and metrics["cut"]
    assert metrics["deleted"] == 750
    assert metrics["labels_equal_host_soa"]
    assert 0.5 < metrics["ari_after_inserts"] <= 1.0
    assert last["slots"].shape == (1000, chip_smoke.T)
    assert last["sizes"].shape == (last["n_slots"],)
    assert len(last["restored"]) == 3000 - 750


def test_dict_path_runs_on_cpu():
    """Phase 3b at a tiny size: batched-device on the CPU (the plain
    ``lsh_hash``) over phase 3's stream, equal to phase 3's host soa
    labels and deltas; no kernel launches on the CPU."""
    metrics, last = chip_smoke.run_main_path(3000, "cpu")
    kept = last["host_stream"]
    assert len(kept["insert_deltas"]) == 3 and len(kept["labels"]) == 0
    assert len(kept["delete_deltas"]) == 1
    dm, dl = chip_smoke.run_dict_path(3000, "cpu", kept)
    assert dm["points"] == 3000 and dm["cut"] and dm["deleted"] == 750
    assert dm["labels_equal_host_soa"] and dm["restored_forest_equal"]
    assert dm["labels_compared"] == 2
    assert dm["ari_after_inserts"] == metrics["ari_after_inserts"]
    assert dm["ari_after_deletes"] == metrics["ari_after_deletes"]
    assert dm["deltas"] == metrics["deltas"]
    assert dm["stats"]["n_links"] > 0 and dm["stats"]["n_cuts"] > 0
    assert dm["launches"] == {k: 0 for k in dm["launches"]}
    assert 0 < dm["hash_call_share_of_insert"] < 1
    assert dl["x"].shape == (1000, chip_smoke.D)
    assert dl["keys"].shape == (1000, chip_smoke.T, 2)


def test_dict_path_refuses_a_different_stream():
    """The dict phase fails, not passes, when the host engine's results
    it is held against differ."""
    import numpy as np

    _metrics, last = chip_smoke.run_main_path(2000, "cpu")
    kept = last["host_stream"]
    bad = kept["insert_deltas"][1].copy()
    bad[0, 2] = 10**6
    kept["insert_deltas"][1] = bad
    with pytest.raises(AssertionError, match="batch 1: insert deltas"):
        chip_smoke.run_dict_path(2000, "cpu", kept)
    kept["insert_deltas"][1] = np.zeros((0, 3), np.int64)
    with pytest.raises(AssertionError, match="batch 1: insert deltas"):
        chip_smoke.run_dict_path(2000, "cpu", kept)


def test_baselines_path_runs_on_cpu():
    metrics, x = chip_smoke.run_baselines(2500, "cpu")
    assert metrics["points"] == 2500 and metrics["cut"]
    for backend in chip_smoke.BASELINES:
        # the metrics round: a perfect labelling may give 1 + 2e-16
        assert 0.5 < metrics[backend]["ari"] < 1.0 + 1e-9
        assert 0.5 < metrics[backend]["nmi"] < 1.0 + 1e-9
    assert metrics["dynamic"]["restore_labels_equal"]
    assert metrics["naive"]["restore_labels_equal"]
    assert metrics["emz-static"]["restore_labels_equal"]
    # the CPU runs the plain version, which counts no launch
    assert metrics["launches"]["eps_neighbor_counts"] == 0
    assert metrics["eps_counts_max_abs_err"] == 0
    assert metrics["eps_counts_mean"] > chip_smoke.K
    assert x.shape == (2500, chip_smoke.D) and x.dtype.name == "float32"


def test_eps_composite_and_bound_on_cpu():
    import numpy as np

    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(300, 10)) * 0.4).astype(
        np.float32))
    comp = chip_smoke.composite_eps_counts(x, chip_smoke.EPS)
    plain = ops.eps_neighbor_counts(x, eps=chip_smoke.EPS)
    # another f32 order: only boundary rows may differ
    assert comp.dtype == torch.int32
    assert int((comp != plain).sum()) <= 3
    # each unordered pair once: n(n+1)/2 pairs of 2d+5 operations
    assert chip_smoke.eps_ops(3, 10) == 6 * 25
    ms, by = chip_smoke.bound(4 * 200_000 * 11,
                              chip_smoke.eps_ops(200_000, chip_smoke.D))
    assert by == "operations" and 14.8 < ms < 15.1
    # the count over all n^2 ordered pairs, reported beside it
    ms, by = chip_smoke.bound(4 * 200_000 * 11,
                              200_000 ** 2 * (2 * chip_smoke.D + 4))
    assert by == "operations" and 28 < ms < 29.5


def test_lm_path_runs_on_cpu():
    out, ctx = chip_smoke.run_lm_path("cpu")
    assert out["arch"] == "gemma3-27b" and out["n_layers"] == 6
    assert out["window"] == 32 and out["prefill_logits_finite"]
    # the CPU runs the plain attention, which counts no launch
    assert out["flash_launches_per_forward"] == 0
    check = out["flash_check"]
    assert check["sweep_cases"] == len(chip_smoke.FLASH_SWEEP)
    assert check["window"]["err_f32"] <= chip_smoke.FLASH_F32_TOL
    assert out["prefill_vs_decode"]["max_abs_err"] <= chip_smoke.LM_TOL
    serving = out["serving"]
    assert serving["requests"] == chip_smoke.SERVE_REQUESTS
    assert serving["generated_tokens"] == chip_smoke.SERVE_REQUESTS * 4
    assert serving["clusters"] == [0, 1]
    assert ctx["q"].shape == (1, 4, 80, 16)


def test_families_phase_runs_on_cpu():
    """Phase 9 at each arch's smoke config: the forward (no launch on the
    CPU), clustered serving, f32 prefill vs decode for the ssm and hybrid
    archs, and ``launch.serve``'s defaults (``mamba2-780m``)."""
    out = chip_smoke.run_families_phase("cpu", "cpu")
    assert list(out["archs"]) == [a for a, _, _ in chip_smoke.FAMILY_RUNS]
    calls = {a: m["attention_calls"] for a, m in out["archs"].items()}
    assert calls == {"mamba2-780m": 0, "hymba-1.5b": 2,
                     "granite-moe-1b-a400m": 2, "llava-next-mistral-7b": 2,
                     "dbrx-132b": 2, "whisper-small": 6}
    for arch, m in out["archs"].items():
        assert m["flash_launches_per_forward"] == 0, arch
        assert m["prefill_logits_finite"], arch
        assert m["serving"]["requests"] == chip_smoke.SERVE_REQUESTS
        assert m["serving"]["generated_tokens"] == \
            chip_smoke.SERVE_REQUESTS * 4
    assert out["archs"]["llava-next-mistral-7b"]["prefill_prefix"] == 4
    for arch in chip_smoke.FAMILY_CHECK_TOL:
        check = out["archs"][arch]["prefill_vs_decode"]
        assert check["tokens"] == 40
        assert check["max_abs_err"] <= chip_smoke.LM_TOL
        assert check["first_mixer"]["max_abs_err"] <= chip_smoke.LM_TOL
    assert out["serve_defaults"]["requests"] == 12
    assert out["serve_defaults"]["generated_tokens"] == 96
    assert out["flash_shapes"] == []


def test_attention_bound_counts_unmasked_pairs():
    assert chip_smoke.unmasked_pairs(4, 4, None) == 10
    assert chip_smoke.unmasked_pairs(4, 4, 2) == 7
    assert chip_smoke.unmasked_pairs(1, 8, None, q_offset=7) == 8
    assert chip_smoke.unmasked_pairs(4096, 4096, None) == 4096 * 4097 // 2
    ms, by, f32_ms, flops, nbytes = chip_smoke.attention_bound(
        1, 32, 16, 4096, 4096, 128, None, 2)
    assert flops == 4 * 128 * 32 * 4096 * 4097 // 2
    assert nbytes == (2 * 32 + 2 * 16) * 4096 * 128 * 2
    assert by == "operations" and 0.138 < ms < 0.140
    assert 2.0 < f32_ms < 2.1
    ms, by, *_ = chip_smoke.attention_bound(1, 32, 16, 4096, 4096, 128,
                                            1024, 2)
    assert by == "operations" and 0.060 < ms < 0.061
    # non-causal (whisper's cross attention): every pair is computed
    *_, flops, nbytes = chip_smoke.attention_bound(1, 12, 12, 448, 1500, 64,
                                                   None, 2, causal=False)
    assert flops == 4 * 64 * 12 * 448 * 1500
    assert nbytes == (2 * 12 * 448 + 2 * 12 * 1500) * 64 * 2


def test_script_refuses_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_kernel_device_ms_survives_a_profiler_that_traces_nothing(
        monkeypatch, capsys):
    """A profiler session may deliver no device activity; the kernel is
    profiled again, and after ``PROFILE_TRIES`` empty sessions it is
    timed with CUDA events, never returned as None."""
    sessions = []

    def events(fn):
        fn()
        sessions.append(1)
        # the second session traces ``a`` only; ``b`` is never traced
        return 0.0, ([("a_kernel", 4.0), ("a_kernel", 2.0)]
                     if len(sessions) == 2 else [])

    calls = {"a": 0, "b": 0}

    def call(name):
        def fn():
            calls[name] += 1
        return fn

    monkeypatch.setattr(chip_smoke, "device_events", events)
    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, reps, warmup: (fn(), 0.25)[1])
    out = chip_smoke.kernel_device_ms({"a": call("a"), "b": call("b")},
                                      reps=2)
    assert out == {"a": 3e-3, "b": 0.25}
    assert len(sessions) == chip_smoke.PROFILE_TRIES
    printed = capsys.readouterr().out
    assert "traced no b launch" in printed
    assert "traced no a launch" not in printed
    # a: 2 calls in each of the 2 sessions until traced; b: 2 in each of
    # the 3 sessions and 1 under CUDA events
    assert calls == {"a": 4, "b": 7}


_PTXAS = """\
ptxas info    : Compiling entry function '_ZN56_GLOBAL__N__f19cc713_23_flash_\
attention_sm90_cu_bed5ab3f27flash_attention_sm90_kernelILi128EEEv14CUtensor\
Map_stS1_S1_P13__nv_bfloat16iiiiiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN56_GLOBAL__N__f19cc713_23_flash_\
attention_sm90_cu_bed5ab3f27flash_attention_sm90_kernelILi128EEEv14CUtensor\
Map_stS1_S1_P13__nv_bfloat16iiiiiiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_Z15lsh_hash_kernelPKfS0_PKiifiiPi' \
for 'sm_90a'
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 40 registers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__e7510225_18_flash_\
attention_cu_23f0aea722flash_attention_kernelILi64EEEvPKfS2_S2_Pfiiiiiiiiif' \
for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 114 registers
"""


def test_build_report_parsers_read_ptxas_and_sass():
    """The build phase's readers of ``-Xptxas -v`` and ``cuobjdump
    -sass`` output name kernels by their demangled identifier."""
    assert chip_smoke.ptxas_report(_PTXAS) == {
        "flash_attention_sm90_kernel<128>": {
            "spill_stores": 0, "spill_loads": 0, "registers": 168},
        "lsh_hash_kernel": {"spill_stores": 4, "spill_loads": 12,
                            "registers": 40},
        "flash_attention_kernel<64>": {"spill_stores": 0, "spill_loads": 0,
                                       "registers": 114}}
    sass = ("\tFunction : _ZN3_GL27flash_attention_sm90_kernelILi64EEEvv\n"
            "  /*0a0*/ HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ ;\n"
            "  /*0b0*/ HGMMA.64x64x16.F32.BF16 R88, R120, gdesc[UR8] ;\n"
            "\tFunction : _Z15lsh_hash_kernelv\n  /*000*/ IMAD R1, R2 ;\n")
    assert chip_smoke.hgmma_counts(sass) == {
        "flash_attention_sm90_kernel<64>": 2, "lsh_hash_kernel": 0}


def test_kernel_names_carry_every_template_argument():
    """The bf16 flash forward's two instantiations (with and without the
    log-sum-exp store) differ in their second argument."""
    base = ("_ZN56_GLOBAL__N__f19cc713_23_flash_attention_sm90_cu_bed5ab3f"
            "27flash_attention_sm90_kernelILi128ELb{}EEEv14CUtensorMap_st")
    assert [chip_smoke._kernel_name(base.format(b)) for b in (0, 1)] == [
        "flash_attention_sm90_kernel<128, false>",
        "flash_attention_sm90_kernel<128, true>"]
    assert chip_smoke._kernel_name(
        "_ZN3_GL30attention_bwd_sm90_dkdv_kernelILi64EEEvv") == \
        "attention_bwd_sm90_dkdv_kernel<64>"


_FWD = "\tFunction : _ZN3_GL27flash_attention_sm90_kernelILi64ELb1EEEvv\n"
_BWD = "\tFunction : _ZN3_GL30attention_bwd_sm90_dkdv_kernelILi64EEEvv\n"
_DELTA = "\tFunction : _ZN3_GL31attention_bwd_sm90_delta_kernelEvv\n"
_MMA = "  /*0a0*/ HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ ;\n"


@pytest.mark.parametrize("sass,ok", [
    (_FWD + _MMA + _BWD + _MMA + _DELTA, True),
    (_BWD + _MMA + _DELTA, False),          # the forward is missing
    (_FWD + _MMA + _DELTA, False),          # the backward is missing
    (_FWD + _MMA + _BWD + _DELTA, False),   # a backward without HGMMA
], ids=["both", "no_forward", "no_backward", "backward_without_hgmma"])
def test_hgmma_gate_needs_the_forward_and_the_backward(sass, ok):
    """The build phase's gate: the bf16 forward and its backward kernel
    each hold HGMMA; the backward's rowsum pass is not counted."""
    if ok:
        assert chip_smoke.flash_hgmma(sass) == {
            "flash_attention_sm90_kernel<64, true>": 1,
            "attention_bwd_sm90_dkdv_kernel<64>": 1}
    else:
        with pytest.raises(AssertionError, match="HGMMA"):
            chip_smoke.flash_hgmma(sass)


@pytest.mark.parametrize("got,ok", [
    ({"kernel": 8, "plain": 0}, True),
    ({"kernel": 7, "plain": 1}, False),     # one backward took the plain
    ({"kernel": 7, "plain": 0}, False),     # one backward is missing
    ({"kernel": 16, "plain": 0}, False),    # counted twice
])
def test_backward_check_refuses_a_plain_or_missing_backward(got, ok):
    """Phases 8, 10 and 12 require every bf16 attention backward of a
    train step on the card to launch ``attention_bwd_sm90``."""
    if ok:
        chip_smoke.check_backward("x", got, 8)
    else:
        with pytest.raises(AssertionError, match="attention backward"):
            chip_smoke.check_backward("x", got, 8)


def test_ptxas_names_bool_template_kernels():
    """The eps kernel's two staging modes are instantiations of one
    template on a bool; the build phase tells them apart."""
    log = ("ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__0"
           "a1b2c3d_16_pairwise_dist_cu_9f8e7d6c26eps_neighbor_counts_kernel"
           "ILb1EEEvPKfS2_iixixfPi' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 128 registers\n"
           "ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__0"
           "a1b2c3d_16_pairwise_dist_cu_9f8e7d6c26eps_neighbor_counts_kernel"
           "ILb0EEEvPKfS2_iixixfPi' for 'sm_90a'\n"
           "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill "
           "loads\nptxas info    : Used 128 registers\n")
    assert chip_smoke.ptxas_report(log) == {
        "eps_neighbor_counts_kernel<true>": {
            "spill_stores": 0, "spill_loads": 0, "registers": 128},
        "eps_neighbor_counts_kernel<false>": {
            "spill_stores": 8, "spill_loads": 8, "registers": 128}}


def test_approx_and_tiered_paths_run_on_cpu(monkeypatch):
    """Phases 3c and 3d on the CPU at a small size (the tier's operating
    point cut to quality_speed's SMOKE workload): (a) the device path at
    rate 0.5 beside its host twin, (b) at rate 1.0 against phase 3's host
    soa results, (c) at rate 0.1; the tiered index's back tier equal to
    (c)'s host soa labels; no kernel launches on the CPU."""
    monkeypatch.setattr(chip_smoke, "TIER_POINT", dict(
        n_stream=3000, window=2000, batch=500, d=8, n_clusters=4,
        cluster_std=0.4, k=32, t=8, eps=0.5, data_seed=3))
    _metrics, last = chip_smoke.run_main_path(3000, "cpu")
    kept = last.pop("host_stream")
    out, masked, soa_labels = chip_smoke.run_approx_path(3000, "cpu", kept)
    a, b, c = out["a"], out["b"], out["c"]
    assert a["core_k"] == 5 and a["stats_passes"] == 3
    assert a["deltas_equal_host"] and a["restore_labels_equal"]
    assert 0.0 <= a["ari_vs_exact_after_deletes"] <= 1.0
    assert b["labels_equal_phase3_soa"] and b["core_k"] == 10
    assert c["core_k"] == 3 and c["deleted"] == 1000 and c["batches"] == 6
    assert not any(a["launches"].values())
    ns = len(masked["sizes_before"])
    assert masked["slots"].shape == (1000, 10) and masked["k"] == 5
    assert len(masked["support"]) == 1000 and len(masked["core"]) == ns
    tier = chip_smoke.run_tiered_path(soa_labels)
    assert tier["back_equal_host_soa"] and tier["lag"] == 0
    assert tier["labels_served"] == 2000
    assert 0.0 <= tier["divergence_ari"] <= 1.0


def test_approx_path_refuses_a_different_stream():
    """The rate-1.0 run is held against phase 3's kept results: a stream
    of another length fails."""
    _metrics, last = chip_smoke.run_main_path(2000, "cpu")
    kept = last.pop("host_stream")
    with pytest.raises(AssertionError, match="insert batches"):
        chip_smoke.run_approx_path(3000, "cpu", kept)


def test_train_phase_runs_on_cpu(tmp_path):
    """Phase 8 at a tiny size with the plain kernels: (a) phase 3's index
    through save_index / restore_index, equal to phase 3 after it; (b)
    curation on soa-device (CPU) beside host soa; (c) the trainer on
    granite-20b's smoke config, step 1 equal to the plain attention's;
    (d) the reference trainer's protocol at the smoke config."""
    _metrics, last = chip_smoke.run_main_path(3000, "cpu")
    kept = last.pop("host_stream")
    tr = chip_smoke.run_train_phase(3000, "cpu", kept, "cpu")
    a, b, c, d = tr["a"], tr["b"], tr["c"], tr["d"]
    assert a["equal_to_phase_3"] and a["saved_after_batch"] == 1
    assert a["restored_insert_batches"] == 2 and a["bytes"] > 0
    assert a["files"] == ["manifest.json", "state.npz"]
    assert b["masks_ids_labels_equal"] and b["seen"] == 40 * 8
    assert b["clusters"] > 0
    chk = b["pass_check"]
    assert chk["rows"] == 8 and chk["t"] == 8
    assert chk["lsh_hash_resolve_max_abs_err"] == 0
    assert chk["bucket_insert_pass_max_abs_err"] == 0
    assert c["n_layers"] == 2 and c["steps"] == 4 and len(c["losses"]) == 4
    assert c["step1"]["loss_rel_err"] == 0.0  # the same plain attention
    assert c["step1"]["kernel_pass"]["grad_norm_rel_err"] == 0.0
    for kind in ("rows", "keys"):  # a planted fault moves the gradient
        assert c["step1"]["planted_faults"][kind]["grad_norm_rel_err"] > 0
    assert c["grads_finite_nonzero"] == 21
    assert not c["flash_launches"]  # no kernel on the CPU
    assert c["bwd_launches"] == d["bwd_launches"] == {"kernel": 0,
                                                       "plain": 0}
    assert d["last_5_mean"] < d["first_3_mean"]
    assert len(d["resumed_losses"]) == 2
    assert d["checkpoints"] == ["step_00000020", "step_00000030"]


def test_curation_phase_holds_the_device_index_not_only_the_mask(
        monkeypatch):
    """A device index whose cluster ids are off keeps the same masks (the
    policy reads only cluster sizes): 8 (b) finds it in ``labels()``.
    A wrong support count on the device changes the masks too."""
    from repro_torch.api import NOISE
    from repro_torch.api.backends import SoAIndex
    from repro_torch.kernels import ops

    labels = SoAIndex.labels

    def renamed(self, ids=None):
        got = labels(self, ids)
        if not self.engine.use_device:
            return got
        return {i: v if v == NOISE else v + 10**6 for i, v in got.items()}
    with monkeypatch.context() as m:
        m.setattr(SoAIndex, "labels", renamed)
        with pytest.raises(AssertionError,
                           match=r"8 \(b\): batch \d+: labels\(\) differ"):
            chip_smoke.curation_path("cpu", 40, "cpu")
    fn = ops.bucket_insert_pass

    def off_by_one(slots, sizes, *, k, impl=None, **kw):
        out = fn(slots, sizes, k=k, impl=impl, **kw)
        if impl != "ref":
            out[-len(slots):] += 1
        return out
    monkeypatch.setattr(ops, "bucket_insert_pass", off_by_one)
    with pytest.raises(AssertionError, match=r"8 \(b\): keep mask \d+"):
        chip_smoke.curation_path("cpu", 40, "cpu")


def test_index_checkpoint_phase_refuses_a_different_stream(tmp_path):
    _metrics, last = chip_smoke.run_main_path(3000, "cpu")
    kept = last.pop("host_stream")
    bad = kept["insert_deltas"][2].copy()
    bad[0, 2] = 10**6
    kept["insert_deltas"][2] = bad
    with pytest.raises(AssertionError, match="8 \\(a\\): insert 2"):
        chip_smoke.index_checkpoint_path(3000, "cpu", kept, tmp_path)


def test_train_phase_gates_step_one(tmp_path, monkeypatch):
    """Step 1 is held against the plain attention's: a bound of -1 (no
    difference allowed, not even none) fails the phase."""
    monkeypatch.setattr(chip_smoke, "TRAIN_LOSS_RTOL", -1.0)
    with pytest.raises(AssertionError, match="step 1 differs"):
        chip_smoke.train_path("cpu", tmp_path)


def test_plain_attention_swaps_the_model_attention():
    from repro_torch.kernels import ops

    fn = ops.attention
    with chip_smoke.plain_attention():
        assert ops.attention is not fn
        assert ops.attention.keywords == {"impl": "ref"}
    assert ops.attention is fn


def test_cells_phase_runs_on_cpu():
    """Phase 10 at the smoke configs: every cell of ``cell_grid`` (29:
    prefill and decode for the ten archs, long_500k for three, train_4k
    for one arch a family), each reckoned on ``meta`` first, run through
    ``launch.cells.build_cell`` on the CPU, its train step's step 1 equal
    to the plain attention's (on the CPU both are the plain version)."""
    out = chip_smoke.run_cells_phase("cpu", "cpu")
    grid = chip_smoke.cell_grid()
    assert [(c["arch"], c["shape"]) for c in out["cells"]] == \
        [(a, s) for a, shapes in grid for s in shapes]
    assert len(out["cells"]) == 29
    assert sum(s == "long_500k" for _, shapes in grid for s in shapes) == 3
    for c in out["cells"]:
        assert c["flops"] > 0 and c["state_bytes"] > 0
        assert c["step_ms"] > 0 and c["share"] > 0
        assert c["flash_checks"] == []
        assert c["bwd_launches"] == {"kernel": 0, "plain": 0}
        if c["kind"] == "train":
            assert c["step1"]["loss_rel_err"] == 0
            assert c["step1"]["grad_norm_rel_err"] == 0
            assert c["params_changed_and_finite"]
        if c["kind"] == "prefill":
            # mamba2 runs no attention: its flash path is the plain one
            assert ("kernel_bound_ms" in c) == (c["arch"] != "mamba2-780m")
            assert c.get("kernel_bound_ms", 0) <= c["bound_ms"]
    trains = {c["arch"] for c in out["cells"] if c["kind"] == "train"}
    assert trains == set(chip_smoke.CELL_TRAIN_ARCHS)
    assert out["cells"][-1]["shape"] == "train_4k"


def test_cell_cuts_reckoned_for_the_card():
    """Each card cell as phase 10 cuts it: the published widths, depth at
    most the published; a prefill keeps its 32,768 tokens, and its
    attention calls (for the flash-path bound) match
    ``attention_calls``.  The state and predicted peak are checked
    against the card by the phase itself, before each run."""
    from repro_torch.configs import get_config

    for arch, shapes in chip_smoke.cell_grid():
        for sid in shapes:
            cfg, shape = chip_smoke.cell_sizes(arch, sid, "cuda")
            pub = get_config(arch)
            assert (cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab_size) == \
                (pub.d_model, pub.n_heads, pub.d_ff, pub.vocab_size)
            assert cfg.n_layers <= pub.n_layers
            if shape.kind == "prefill":
                assert shape.seq_len == 32768
                calls = chip_smoke.prefill_attention_calls(cfg, shape)
                assert len(calls) == chip_smoke.attention_calls(cfg)


def test_mesh_train_phase_runs_on_cpu():
    """Phase 12 at the smoke configs on a (1, 1) mesh of a gloo world of
    one: (a) the mesh train step equals the unsharded one exactly (the
    bodies keep the unsharded arithmetic at world 1); (b) the
    expert-parallel step is within its f32 bound of the dense dispatch's;
    (c) a save on the mesh restored onto it and unsharded, each taking
    the uninterrupted run's second step exactly."""
    out = chip_smoke.run_mesh_train_phase("cpu", device="cpu")
    a, b, c = out["a"], out["b"], out["c"]
    assert a["exact"], a
    assert a["accum"] == chip_smoke.MESH_TRAIN_ACCUM
    assert len(a["mesh_steps"]) == chip_smoke.MESH_TRAIN_STEPS
    assert a["flash_check"] == []           # the kernel is the card's
    assert a["bwd_launches"] == {"kernel": 0, "plain": 0}
    assert b["m_rel_err"] <= b["tol"] and b["loss_rel_err"] <= b["tol"]
    assert b["drops_no_drops_capacity"] == 0
    assert c["losses"]["restored_on_mesh"] == c["losses"]["uninterrupted"]
    assert c["unsharded_exact"], c
    assert "multi" not in out


def _mesh_analysis_record(mesh, **kw):
    rec = {"arch": "granite-20b", "layers": 4, "mesh": list(mesh),
           "status": "ok", "flops_per_device": 2.0,
           "hbm_bytes_per_device": 3.0,
           "collective_bytes_per_device": 0.0 if mesh == (1, 1) else 5.0}
    if mesh == (1, 1):
        rec["one_card"] = {"flops_per_device": 2.0,
                           "hbm_bytes_per_device": 3.0}
    rec.update(kw)
    return rec


def test_mesh_analysis_phase_runs_on_cpu():
    """Phase 13's child process here (one card's runs: 12 (a) and 11 on
    (1, 1)), its gates held, each bound beside the step ms its phase
    measured (here stand-ins shaped as phases 11 and 12 report them)."""
    mesh = {"parts": [{"ranks": [{"archs": [
        {"arch": "gemma3-27b", "own": {"prefill_ms": 70.0}},
        {"arch": "granite-moe-1b-a400m", "own": {"prefill_ms": 300.0}}]}]}]}
    mt = {"a": {"mesh_steps": [{"ms": 600.0}, {"ms": 580.0}]}}
    out = chip_smoke.run_mesh_analysis_phase("cpu", 1, mesh, mt)
    a, b = out["runs"]
    assert (a["phase"], a["arch"], a["mesh"]) == ("12 (a)", "granite-20b",
                                                  [1, 1])
    assert a["grad_accum"] == chip_smoke.MESH_TRAIN_ACCUM
    assert (b["phase"], b["arch"], b["batch"]) == (
        "11", "gemma3-27b", list(chip_smoke.MESH_PREFILL))
    assert a["measured_ms"] == [580.0] and b["measured_ms"] == [70.0]
    for r in (a, b):
        assert r["bound_share"] == r["bound_ms"] / r["measured_ms"][0]
        assert r["terms_ms"]["collective"] == 0 and r["bound_ms"] > 0
    assert len(chip_smoke.mesh_analysis_runs(4)) == 5


@pytest.mark.parametrize("fault", ["error", "flops", "bytes", "collective",
                                   "silent mesh"])
def test_mesh_analysis_gates_refuse(fault):
    """A run that failed, a (1, 1) run whose FLOPs or bytes are not the
    one-card analysis's or that sends bytes, a mesh of several cards
    that sends none: each fails phase 13."""
    good = [_mesh_analysis_record((1, 1)), _mesh_analysis_record((2, 2))]
    chip_smoke.mesh_analysis_gates(good)
    bad = {"error": [_mesh_analysis_record((1, 1), status="error",
                                           error="boom")],
           "flops": [_mesh_analysis_record((1, 1), flops_per_device=2.5)],
           "bytes": [_mesh_analysis_record((1, 1),
                                           hbm_bytes_per_device=4.0)],
           "collective": [_mesh_analysis_record(
               (1, 1), collective_bytes_per_device=1.0)],
           "silent mesh": [_mesh_analysis_record(
               (1, 4), collective_bytes_per_device=0.0)]}[fault]
    with pytest.raises(AssertionError, match="13: granite-20b"):
        chip_smoke.mesh_analysis_gates(bad)


def test_mesh_analysis_refuses_a_failed_child(monkeypatch, tmp_path):
    """The child process cannot import the script: phase 13 fails."""
    monkeypatch.setattr(chip_smoke, "ROOT", tmp_path)
    with pytest.raises(RuntimeError, match="13: the analysis process"):
        chip_smoke.mesh_analysis_child(1)


def test_examples_phase_runs_on_cpu():
    """Phase 14 with ``--device cpu`` (the trainer cut to 2 steps): the
    analysis clean over all six passes, every example run, the
    clustering ones equal between their two runs; no launch on the CPU,
    so the launch gates, which hold on the card, are not asked."""
    ex = chip_smoke.run_examples_phase("cpu", "cpu", train_steps=2)
    a = ex["analysis"]
    assert a["n_findings"] == 0
    assert tuple(sorted(a["counts"])) == chip_smoke.ANALYSIS_PASSES
    assert list(ex["runs"]) == ["torch_quickstart",
                                "torch_streaming_clustering",
                                "torch_curation_pipeline", "torch_serve_lm",
                                "torch_train_lm"]
    q = ex["runs"]["torch_quickstart"]
    assert q["card"]["lines"] == q["cpu"]["lines"]
    assert q["card"]["lines"][0] == "backend: soa-device"
    s = ex["runs"]["torch_streaming_clustering"]["card"]
    assert len(s["lines"]) == 12 + 2 and s["insert_batches"] == 12
    assert s["lines"][-1] == "post-expiry ARI: 1.0"
    c = ex["runs"]["torch_curation_pipeline"]
    assert c["card"]["lines"] == c["cpu"]["lines"]
    assert ex["runs"]["torch_serve_lm"]["card"]["lines"][0].startswith(
        "served 12 requests")
    t = ex["runs"]["torch_train_lm"]["card"]
    assert t["argv"] == ["--device", "cpu", "--steps", "2"]
    assert t["lines"][-1].startswith("final loss")
    for r in ex["runs"].values():
        assert not any(r["card"]["launches"].values())
    assert ex["wall_s"] > 0


def test_examples_phase_refuses_a_finding(tmp_path, monkeypatch):
    """The analysis child finds a host sync in a kernel wrapper of the
    tree it is pointed at: phase 14 fails before any example runs (here
    with no PYTHONPATH set, as the script runs on the card)."""
    monkeypatch.delenv("PYTHONPATH", raising=False)
    bad = tmp_path / "repro_torch" / "kernels" / "wrap.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("def wrapper(x):\n    return x.sum().item()\n")
    with pytest.raises(AssertionError, match=r"(?s)14: python -m "
                       r"repro_torch.analysis exited 1.*HOT002"):
        chip_smoke.run_examples_phase("cpu", "cpu", train_steps=2,
                                      analysis_root=tmp_path)


def test_examples_phase_refuses_unequal_numbers(monkeypatch):
    """A card run whose printed ARI differs from the CPU run's fails
    phase 14; a difference in seconds alone does not."""
    line = "n={:6d}  soa-device ARI={} ({:5.2f}s cum)   emz-static " \
           "ARI=1.000 ( 0.02s cum)"
    run = {"lines": [line.format(1000, "1.000", 1.25)]}
    chip_smoke.same_numbers(run, {"lines": [line.format(1000, "1.000",
                                                        3.5)]}, "t")
    with pytest.raises(AssertionError, match="14: t"):
        chip_smoke.same_numbers(run, {"lines": [line.format(1000, "0.998",
                                                            1.25)]}, "t")
    real, calls = chip_smoke.run_example, []

    def doctored(name, argv, **sizes):
        """The phase's second run of an example (its CPU run) prints
        another ARI."""
        out = real(name, argv, **sizes)
        calls.append(name)
        if calls.count(name) == 2:
            out["lines"] = [ln.replace("ARI vs ground truth: 1.0",
                                       "ARI vs ground truth: 0.9981")
                            for ln in out["lines"]]
        return out

    monkeypatch.setattr(chip_smoke, "analysis_child", lambda root: {})
    monkeypatch.setattr(chip_smoke, "run_example", doctored)
    with pytest.raises(AssertionError, match="14: torch_quickstart"):
        chip_smoke.run_examples_phase("cpu", "cpu", train_steps=2)
