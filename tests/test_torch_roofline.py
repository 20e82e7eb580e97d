"""``repro_torch.launch.{step_analysis,dryrun,roofline}`` on the CPU.

- ``model_flops`` equals ``repro.launch.roofline.model_flops`` for every
  arch and shape; ``roofline_row``'s terms are the record's counts over
  the H100 constants (989 TFLOP/s bf16, 3.35 TB/s).
- ``analyze_step`` on 5 chained matrix products counts exactly
  2·m·n·k·5 FLOPs and Σ (operands + result) bytes, the views between
  them free; ``bmm``, ``baddbmm``, ``addmm`` and ``einsum`` count as
  products, element-wise work does not; the live-bytes peak.
- On smoke cells, ``analyze_step``'s FLOPs against
  ``repro.launch.hlo_analysis.analyze_compiled`` of the reference's step
  compiled without a mesh.  Measured (counts, the same on any machine):
  prefill 1.0000 for the attention families and 1.0367 for mamba2 (the
  SSD's products are grouped differently), train 0.9956–1.0510 (where
  the port's step counts more is not split).  Held within 5% (prefill)
  and 6% (train).
- ``analyze_cell``'s depth extension equals the whole stack's analysis.
- The dry-run CLI over all ten archs' smoke configs (``--smoke``: the
  four shapes cut by 32) covers every cell with ``ok`` or the documented
  skip, as ``tests/test_dryrun_artifacts.py`` asks of the reference, and
  the roofline table derives from it.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.launch import cells as jcells  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch.hlo_analysis import analyze_compiled  # noqa: E402
from repro.models.registry import build_model as jax_build  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro.training import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.cells import build_cell  # noqa: E402
from repro_torch.launch.step_analysis import analyze_step  # noqa: E402

PREFILL_FLOPS_RTOL = 0.05
TRAIN_FLOPS_RTOL = 0.06


@pytest.mark.parametrize("arch", list(jconfigs.ARCH_IDS))
def test_model_flops_matches_reference(arch):
    for sid in jconfigs.SHAPES:
        assert roofline.model_flops(configs.get_config(arch),
                                    configs.get_shape(sid)) == \
            jroofline.model_flops(jconfigs.get_config(arch),
                                  jconfigs.get_shape(sid))


def test_roofline_row_uses_the_h100_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)
    rec = {"arch": "phi3-mini-3.8b", "shape": "train_4k", "mesh": "1xH100",
           "chips": 1, "flops_per_device": 3.0e15,
           "hbm_bytes_per_device": 2.0e13, "collective_bytes_per_device": 0,
           "state_bytes": 6.0e10, "peak_bytes_per_device": 7.0e10,
           "fits_one_card": True}
    cfg, shape = configs.get_config(rec["arch"]), configs.get_shape("train_4k")
    row = roofline.roofline_row(rec, cfg, shape)
    assert row["t_comp_s"] == 3.0e15 / 989e12
    assert row["t_mem_s"] == 2.0e13 / 3.35e12
    assert row["dominant"] == "memory" and "t_coll_s" not in row
    assert row["bound_time_s"] == row["t_mem_s"]
    mf = roofline.model_flops(cfg, shape)
    assert row["useful_ratio"] == mf / 3.0e15
    assert row["mfu_upper_bound"] == mf / (989e12 * row["t_mem_s"])


def test_analyze_step_counts_chained_products_exactly():
    """x (m, k) through w (k, n), its transpose (n, k), ...: 5 products of
    2·m·n·k FLOPs each; bytes Σ (m·k + k·n + m·n) · 4 a product; the
    ``.T`` views and a reshape are free."""
    m, k, n = 48, 32, 40
    x = torch.empty((m, k), device="meta")
    w = torch.empty((k, n), device="meta")

    def chain(x, w):
        for i in range(5):
            x = x @ (w if i % 2 == 0 else w.T)
        return x.reshape(-1)

    got = analyze_step(chain, x, w)
    assert got["flops_per_device"] == 2 * m * n * k * 5
    assert got["hbm_bytes_per_device"] == 5 * (m * k + k * n + m * n) * 4
    assert got["collective_bytes_per_device"] == 0
    assert got["counted_ops"] == 5
    # the arguments, then the two largest products alive at once
    assert got["peak_bytes_per_device"] == (m * k + k * n) * 4 + \
        (m * n + m * k) * 4


def test_analyze_step_counts_batched_products_not_elementwise():
    b, m, k, n = 3, 8, 16, 4
    a = torch.empty((b, m, k), device="meta")
    c = torch.empty((b, k, n), device="meta")
    bias = torch.empty((m, n), device="meta")

    def step(a, c, bias):
        y = torch.einsum("bmk,bkn->bmn", a, c)     # bmm
        y = torch.baddbmm(y, a, c)
        z = torch.addmm(bias, a[0], c[0])
        return torch.relu(y) * 2 + z

    got = analyze_step(step, a, c, bias)
    assert got["flops_per_device"] == 2 * (2 * b * m * n * k) + 2 * m * n * k


def _jax_prefill(arch, S, B):
    jcfg = jconfigs.get_config(arch).smoke()
    jm = jax_build(jcfg)
    pshapes, _ = jcells.abstract_params(jm)
    bs, _ = jcells.batch_specs(jcfg, JShape("p", S, B, "prefill"), False)
    return jax.jit(lambda p, b: jm.forward(p, b, None)).lower(
        pshapes, bs).compile()


def _port(arch, sid, S, B, kind):
    cell = build_cell(arch, sid, device="meta",
                      cfg=configs.get_config(arch).smoke(),
                      shape=ShapeConfig(sid, S, B, kind))
    return analyze_step(cell.step_fn, *cell.args)


@pytest.mark.parametrize("arch,exact", [("phi3-mini-3.8b", True),
                                        ("whisper-small", True),
                                        ("mamba2-780m", False)])
def test_prefill_flops_agree_with_reference_hlo(arch, exact):
    want = analyze_compiled(_jax_prefill(arch, 128, 2))["flops_per_device"]
    got = _port(arch, "prefill_32k", 128, 2, "prefill")["flops_per_device"]
    if exact:
        assert got == want
    assert abs(got / want - 1) <= PREFILL_FLOPS_RTOL, got / want


def test_train_flops_agree_with_reference_hlo():
    arch, S, B = "phi3-mini-3.8b", 64, 8
    jcfg = jconfigs.get_config(arch).smoke()
    jm = jax_build(jcfg)
    pshapes, _ = jcells.abstract_params(jm)
    bs, _ = jcells.batch_specs(jcfg, JShape("t", S, B, "train"), True)
    opt = JAdamW(lr=jax_warmup_cosine(3e-4, 100, 10_000))
    step = jax_make_train_step(jm, opt, mesh=None, grad_accum=4)
    compiled = jax.jit(step).lower(pshapes, jax.eval_shape(opt.init, pshapes),
                                   bs).compile()
    want = analyze_compiled(compiled)["flops_per_device"]
    got = _port(arch, "train_4k", S, B, "train")["flops_per_device"]
    print(f"train FLOPs, port / reference HLO: {got / want:.4f}")
    assert abs(got / want - 1) <= TRAIN_FLOPS_RTOL, got / want


@pytest.mark.parametrize("arch,sid,depth", [
    ("gemma3-27b", "decode_32k", 20), ("gemma3-27b", "train_4k", 20),
    ("hymba-1.5b", "prefill_32k", 4), ("whisper-small", "train_4k", 3)])
def test_depth_extension_equals_whole_stack(arch, sid, depth):
    cfg = dryrun.at_depth(configs.get_config(arch).smoke(), depth)
    kind = configs.get_shape(sid).kind
    shape = ShapeConfig(sid, 16 if kind == "train" else 40,
                        1 if kind == "train" else 2, kind)
    ext = dryrun.analyze_cell(arch, sid, cfg=cfg, shape=shape)
    assert "analyzed_depths" in ext
    whole = build_cell(arch, sid, device="meta", cfg=cfg, shape=shape)
    want = analyze_step(whole.step_fn, *whole.args)
    for k in ("flops_per_device", "hbm_bytes_per_device", "counted_ops"):
        assert ext[k] == want[k], k
    assert ext["peak_bytes_per_device"] == pytest.approx(
        want["peak_bytes_per_device"], rel=0.05)


def test_dryrun_cli_covers_every_smoke_cell(tmp_path):
    out = tmp_path / "torch_dryrun.json"
    assert dryrun.main(["--all", "--smoke", "--out", str(out)]) == 0
    recs = {(r["arch"], r["shape"]): r for r in json.loads(out.read_text())}
    assert len(recs) == 40
    for arch in configs.ARCH_IDS:
        for sid in configs.SHAPES:
            r = recs[(arch, sid)]
            assert (r["mesh"], r["chips"]) == ("1xH100", 1)
            ok, why = configs.cell_supported(arch, sid)
            if ok:
                assert r["status"] == "ok", r.get("error")
                assert r["flops_per_device"] > 0
                assert r["hbm_bytes_per_device"] > 0
                assert r["collective_bytes_per_device"] == 0
                assert r["state_bytes"] > 0 and r["fits_one_card"]
                assert r["peak_bytes_per_device"] >= r["state_bytes"]
            else:
                assert (r["status"], r["reason"]) == ("skipped", why)
    rows = roofline.build_table(out)
    ok_rows = [r for r in rows if r["status"] == "ok"]
    assert len(ok_rows) == 33
    for r in ok_rows:
        assert r["t_comp_s"] > 0 and r["t_mem_s"] > 0
        assert r["dominant"] in ("compute", "memory")
        assert 0 < r["useful_ratio"] < 10, r
    text = roofline.format_table(rows)
    assert text.count("[skipped]") == 7
    assert np.isfinite([r["bound_time_s"] for r in ok_rows]).all()
