"""``chip_smoke.py`` on the CPU: its main path runs end to end at a tiny
size with the kernels' plain versions (the port's ``soa-device`` on
``device="cpu"`` against its host ``soa`` engine, labels and deltas
equal), so does its baselines path (the host baselines, then the
eps-ball counts through ``ops`` on the CPU), so does its LM path
(gemma3-27b's smoke config at the phase's depth: prefill, the attention
checks, prefill vs decode, clustered serving), its attention bound
counts the unmasked pairs, and the script itself refuses to run without
a CUDA device."""

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


def test_script_refuses_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


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
