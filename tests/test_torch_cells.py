"""``repro_torch.launch.cells`` against ``repro.launch.cells``, on the CPU.

- The grid: ``ACCUM_OVERRIDES``, ``SHAPES``, ``get_shape``,
  ``LONG_CONTEXT_OK`` and ``cell_supported`` (all 10 x 4 cells, the
  reasons too) equal the reference's.
- ``batch_specs``: the same keys, shapes and dtype names for every arch
  and shape.
- ``abstract_params``: the reference's ``abstract_params`` of each
  arch's smoke config, carried through ``models.convert``'s name map
  (its stacked layers split per layer), has the port's shapes and
  dtypes; and it draws nothing (``init`` afterwards gives the same
  weights).
- One arch per family (dense, moe, vlm, ssm, hybrid, audio) at its smoke
  config with float32 compute: the same weights (``params_from_jax``)
  and the same inputs made from a seed go through the port's cells on
  the CPU and through the reference's functions outside a mesh —
  ``make_train_step(model, opt, mesh=None, grad_accum=accum)`` with the
  cell's AdamW, ``model.forward`` and ``model.decode_step`` — since the
  reference's ``build_cell`` fails inside a mesh in this JAX (ROADMAP.md
  Queue 3, the trainer-mesh caveat).  Tolerance: atol = rtol = 2e-4,
  ``tests/test_torch_families.py``'s float32 bound (the reference's own
  decode-vs-prefill tolerance) for logits, loss, gradient norm, the
  updated parameters and moments, and the new caches.  The mamba2 hazard
  (the reference's SSD gradient is NaN at a full chunk of 256) does not
  arise at these shapes: the chunk is the 32-token sequence, and the
  test requires the reference's gradient norm to be finite.
- ``build_cell``'s kinds, its accumulation clamp, its default device,
  and the moe dispatch in token chunks against one chunk.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import cells as jcells  # noqa: E402
from repro.models.registry import build_model as jax_build  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro.training import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import cells  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

F32_TOL = 2e-4
FAMILY_ARCHS = ["phi3-mini-3.8b", "granite-moe-1b-a400m",
                "llava-next-mistral-7b", "mamba2-780m", "hymba-1.5b",
                "whisper-small"]
TRAIN = ShapeConfig("train_4k", 32, 8, "train")
PREFILL = ShapeConfig("prefill_32k", 48, 2, "prefill")
DECODE = ShapeConfig("decode_32k", 40, 3, "decode")


def _cfgs(arch):
    jcfg = dataclasses.replace(jconfigs.get_config(arch).smoke(),
                               dtype="float32")
    tcfg = dataclasses.replace(configs.get_config(arch).smoke(),
                               dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _weights(jcfg, tcfg, seed=0):
    jm = jax_build(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _to_jax(t):
    a = t.detach().float().numpy() if t.is_floating_point() else t.numpy()
    return jnp.asarray(a).astype({torch.bfloat16: jnp.bfloat16,
                                  torch.float32: jnp.float32,
                                  torch.int32: jnp.int32}[t.dtype])


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=F32_TOL, rtol=F32_TOL)


# ---------------------------------------------------------------------- #
# the grid
# ---------------------------------------------------------------------- #
def test_grid_constants_match_reference():
    assert cells.ACCUM_OVERRIDES == jcells.ACCUM_OVERRIDES
    assert configs.LONG_CONTEXT_OK == jconfigs.LONG_CONTEXT_OK
    assert list(configs.SHAPES) == list(jconfigs.SHAPES)
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for sid in jconfigs.SHAPES:
        assert dataclasses.asdict(configs.get_shape(sid)) == \
            dataclasses.asdict(jconfigs.get_shape(sid))
    cells_seen = 0
    for arch in jconfigs.ARCH_IDS:
        for sid in jconfigs.SHAPES:
            assert configs.cell_supported(arch, sid) == \
                jconfigs.cell_supported(arch, sid)
            cells_seen += 1
    assert cells_seen == 40
    assert sum(not configs.cell_supported(a, s)[0] for a in configs.ARCH_IDS
               for s in configs.SHAPES) == 7


@pytest.mark.parametrize("with_labels", [False, True])
@pytest.mark.parametrize("arch", list(jconfigs.ARCH_IDS))
def test_batch_specs_match_reference(arch, with_labels):
    for sid in jconfigs.SHAPES:
        want, _ = jcells.batch_specs(jconfigs.get_config(arch),
                                     jconfigs.get_shape(sid), with_labels)
        got = cells.batch_specs(configs.get_config(arch),
                                configs.get_shape(sid), with_labels)
        assert sorted(got) == sorted(want)
        for k, spec in got.items():
            assert spec.shape == tuple(want[k].shape), (sid, k)
            assert str(spec.dtype).removeprefix("torch.") == \
                str(want[k].dtype), (sid, k)


@pytest.mark.parametrize("arch", list(jconfigs.ARCH_IDS))
def test_abstract_params_match_reference(arch):
    jcfg = jconfigs.get_config(arch).smoke()
    tcfg = configs.get_config(arch).smoke()
    shapes, _ = jcells.abstract_params(jax_build(jcfg))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    want = params_from_jax(zeros, tcfg, "cpu")
    got = cells.abstract_params(build_model(tcfg, device="cpu"))
    w, g = tree_leaves(want), tree_leaves(got)
    assert len(w) == len(g) > 0
    for a, b in zip(w, g):
        assert b.device.type == "meta"
        assert (tuple(b.shape), b.dtype) == (tuple(a.shape), a.dtype)


def test_abstract_params_draw_nothing():
    """``abstract_params`` leaves ``init``'s draws as they were: the
    weights drawn after it equal those drawn without it."""
    cfg = configs.get_config("hymba-1.5b").smoke()
    model = build_model(cfg, device="cpu")
    before = tree_leaves(model.init(3))
    meta = cells.abstract_params(model)
    after = tree_leaves(model.init(3))
    assert [tuple(t.shape) for t in tree_leaves(meta)] == \
        [tuple(t.shape) for t in before]
    for a, b in zip(before, after):
        assert torch.equal(a, b)


def test_build_cell_kinds_accum_and_default_device():
    """The three kinds; the accumulation is the override clamped to the
    batch (dp_total 1); the cell's default device is the card, and
    building one allocates nothing there."""
    cfg = configs.get_config("phi3-mini-3.8b")
    c = cells.build_cell("phi3-mini-3.8b", "train_4k")
    assert c.device == torch.device("cuda") and c.kind == "train"
    assert c.accum == 4 and not hasattr(c, "lower")
    params, opt_state, batch = c.args
    assert all(t.device.type == "meta" for t in tree_leaves(params))
    assert batch["tokens"].shape == (256, 4096)
    small = dataclasses.replace(configs.get_shape("train_4k"),
                                global_batch=2)
    c = cells.build_cell("phi3-mini-3.8b", "train_4k", device="meta",
                         shape=small)
    assert c.accum == 2
    assert cells.build_cell("qwen1.5-110b", "train_4k", device="meta",
                            shape=small, grad_accum=1).accum == 1
    c = cells.build_cell("gemma3-27b", "long_500k", device="meta",
                         cfg=dataclasses.replace(cfg, n_layers=1))
    assert c.kind == "decode"
    _, caches, token, pos = c.args
    assert caches[0]["k"].shape[2] == 524288
    assert token.shape == (1, 1) and token.dtype == torch.int32
    assert pos.shape == () and pos.dtype == torch.int32
    c = cells.build_cell("whisper-small", "prefill_32k", device="meta")
    assert c.kind == "prefill" and sorted(c.args[1]) == ["frames", "tokens"]


# ---------------------------------------------------------------------- #
# the cells against the reference's functions, outside a mesh
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_cell_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jm, jp, tp = _weights(jcfg, tcfg)
    cell = cells.build_cell(arch, "train_4k", device="cpu", cfg=tcfg,
                            shape=TRAIN)
    assert cell.accum == min(cells.ACCUM_OVERRIDES[(arch, "train_4k")], 8)
    params, opt_state, batch = cell.inputs(7, params=tp)
    jopt = JAdamW(lr=jax_warmup_cosine(3e-4, 100, 10_000))
    jstep = jax.jit(jax_make_train_step(jm, jopt, mesh=None,
                                        grad_accum=cell.accum))
    jbatch = {k: _to_jax(v) for k, v in batch.items()}
    jp2, jo2, jmet = jstep(jp, jopt.init(jp), jbatch)
    assert np.isfinite(float(jmet["grad_norm"]))
    params, opt_state, met = cell.run(params, opt_state, batch)
    for k in ("loss", "grad_norm", "lr"):
        _close(float(met[k]), float(jmet[k]))
    assert int(opt_state["step"]) == int(jo2["step"]) == 1
    conv = lambda tree: params_from_jax(  # noqa: E731
        jax.tree.map(np.asarray, tree), tcfg, "cpu")
    for got, want in ((params, jp2), (opt_state["m"], jo2["m"]),
                      (opt_state["v"], jo2["v"])):
        for g, w in zip(tree_leaves(got), tree_leaves(conv(want))):
            _close(g.numpy(), w.numpy())


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_prefill_cell_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jm, jp, tp = _weights(jcfg, tcfg, seed=1)
    cell = cells.build_cell(arch, "prefill_32k", device="cpu", cfg=tcfg,
                            shape=PREFILL)
    params, batch = cell.inputs(8, params=tp)
    got = cell.run(params, batch)
    want = jm.forward(jp, {k: _to_jax(v) for k, v in batch.items()})
    n_text = batch["tokens"].shape[1]
    n_prefix = tcfg.n_patches if tcfg.family == "vlm" else 0
    assert got.shape == (2, n_text + n_prefix, tcfg.padded_vocab)
    assert not got.requires_grad
    _close(got.numpy(), want)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decode_cell_matches_reference(arch):
    """Caches filled from a seed, pos = S - 1: the step reads every slot
    of the cache."""
    jcfg, tcfg = _cfgs(arch)
    jm, jp, tp = _weights(jcfg, tcfg, seed=2)
    cell = cells.build_cell(arch, "decode_32k", device="cpu", cfg=tcfg,
                            shape=DECODE)
    params, caches, token, pos = cell.inputs(9, params=tp)
    assert int(pos) == DECODE.seq_len - 1 and token.shape == (3, 1)
    assert all(bool((t != 0).any()) for t in tree_leaves(caches))
    jcaches = jax.tree.map(_to_jax, caches)
    want, want_c = jm.decode_step(jp, jcaches, _to_jax(token), _to_jax(pos))
    got, got_c = cell.run(params, caches, token, pos)
    assert got.shape == (3, tcfg.padded_vocab)
    _close(got.numpy(), want)
    for g, w in zip(tree_leaves(got_c), jax.tree.leaves(want_c)):
        _close(g.float().numpy(), w)


def test_moe_dispatch_in_chunks_equals_one_chunk(monkeypatch):
    """The dense dispatch's token chunks (``DISPATCH_BYTES``) compute the
    function of one chunk: output and aux equal, forward and gradient."""
    cfg = configs.get_config("granite-moe-1b-a400m").smoke()
    g = torch.Generator().manual_seed(0)
    p = M.init_moe(g, cfg)
    x = torch.randn(2, 50, cfg.d_model, generator=g, requires_grad=True)
    y1, a1 = M.moe_block_dense(p, x, cfg, torch.float32)
    (gx1,) = torch.autograd.grad((y1.sum() + a1), x)
    per_token = cfg.n_experts * max(cfg.d_ff, cfg.d_model) * 4
    monkeypatch.setattr(M, "DISPATCH_BYTES", 7 * per_token)
    assert M.dispatch_chunk(cfg, torch.float32) == 7
    y2, a2 = M.moe_block_dense(p, x, cfg, torch.float32)
    (gx2,) = torch.autograd.grad((y2.sum() + a2), x)
    torch.testing.assert_close(y2, y1, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(gx2, gx1, atol=1e-6, rtol=1e-6)
    assert float(a2.detach()) == float(a1.detach())
