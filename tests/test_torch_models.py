"""The port's dense LM against the JAX package's, on the CPU.

The same parameters (drawn by ``repro``'s init, carried over by
``repro_torch.models.convert.params_from_jax``) and the same tokens go
through ``repro.models.registry.build_model`` and
``repro_torch.models.registry.build_model``; ``forward`` (prefill) and
teacher-forced ``decode_step`` logits are compared.

Tolerances:
- float32: atol = rtol = 2e-4, the reference's own decode-vs-prefill
  tolerance (``tests/test_arch_smoke.py``).  The two packages sum in
  different f32 orders (XLA's dots against torch's matmul).
- bfloat16: atol = rtol = 0.1 on logits of unit scale.  The two
  frameworks round to bf16 at different places: the port's plain
  attention rounds the logits (its first einsum runs in bf16, as
  ``repro.kernels.ref.attention`` does), JAX's ``chunked_attention``
  computes f32 logits and rounds the probabilities; and their bf16
  matmuls round their outputs differently.  Each rounding moves a value
  by up to 2^-8 of itself, and they compound over the layers.  Measured
  on the CPU: max |diff| 0.066 (forward) and 0.070 (decode) on gemma3's
  logits of magnitude up to 4.1, i.e. about two bf16 ulps there; float32
  differs by at most 3.1e-6.

Configs: ``granite-20b`` smoke (MQA, 2 layers) and ``gemma3-27b`` smoke
cut to 6 layers — one whole 5:1 local:global period, window 32, a
separate global RoPE theta — at 48 and 64 tokens, past the window, so
the kernel's (here: the plain version's) window mask and the decode
path's ring caches both engage.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.registry import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

F32_TOL = 2e-4
BF16_TOL = 0.1


def _cfgs(arch, dtype, n_layers=None):
    changes = {"dtype": dtype}
    if n_layers:
        changes["n_layers"] = n_layers
    jcfg = dataclasses.replace(jax_get_config(arch).smoke(), **changes)
    tcfg = dataclasses.replace(get_config(arch).smoke(), **changes)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


_MODELS = {}


def _models(arch, dtype, n_layers=None, seed=0):
    key = (arch, dtype, n_layers, seed)
    if key not in _MODELS:
        jcfg, tcfg = _cfgs(arch, dtype, n_layers)
        jm = jax_build(jcfg)
        jp, _ = jm.init(jax.random.PRNGKey(seed))
        tm = build_model(tcfg, device="cpu")
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
        _MODELS[key] = (jm, jp, tm, tp)
    return _MODELS[key]


CASES = [("granite-20b", None, 2, 24), ("gemma3-27b", 6, 1, 48),
         ("gemma3-27b", 6, 2, 64)]


@pytest.mark.parametrize("arch,n_layers,b,s", CASES)
def test_forward_matches_jax_f32(arch, n_layers, b, s):
    jm, jp, tm, tp = _models(arch, "float32", n_layers)
    toks = np.random.default_rng(s).integers(0, tm.cfg.vocab_size, (b, s))
    want = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(toks)}))
    got = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    assert got.shape == (b, s, tm.cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("arch,n_layers", [("granite-20b", None),
                                           ("gemma3-27b", 6)])
def test_forward_matches_jax_bf16(arch, n_layers):
    jm, jp, tm, tp = _models(arch, "bfloat16", n_layers)
    toks = np.random.default_rng(5).integers(0, tm.cfg.vocab_size, (2, 48))
    want = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(toks)}),
                      np.float32)
    got = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL,
                               rtol=BF16_TOL)


def _decode_both(jm, jp, tm, tp, toks, kv_len, pos_fn, active_fn=None):
    """Teacher-force ``toks`` through both decode steps; returns the
    stacked (b, s, vp) logits of each and the final caches."""
    b, s = toks.shape
    jc, _ = jm.decode_init(b, kv_len)
    tc = tm.decode_init(b, kv_len)
    jstep = jax.jit(lambda p, c, t, pos, act: jm.decode_step(
        p, c, t, pos, active=act))
    jout, tout = [], []
    for t in range(s):
        pos = pos_fn(t)
        act = None if active_fn is None else active_fn(t)
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                       jnp.asarray(pos),
                       None if act is None else jnp.asarray(act))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]),
                                torch.from_numpy(np.asarray(pos)),
                                None if act is None
                                else torch.from_numpy(act))
        jout.append(np.asarray(jl, np.float32))
        tout.append(tl.float().numpy())
    return np.stack(jout, 1), np.stack(tout, 1), jc, tc


@pytest.mark.parametrize("arch,n_layers,b,s", CASES)
def test_decode_scalar_pos_matches_jax_f32(arch, n_layers, b, s):
    """Batch-synchronous decode (scalar pos): the scalar-pos cache branch
    for full layers, the ring for gemma3's local layers."""
    jm, jp, tm, tp = _models(arch, "float32", n_layers)
    toks = np.random.default_rng(s + 1).integers(0, tm.cfg.vocab_size,
                                                 (b, s))
    jl, tl, jc, tc = _decode_both(jm, jp, tm, tp, toks, s + 8,
                                  lambda t: np.int32(t))
    np.testing.assert_allclose(tl, jl, atol=F32_TOL, rtol=F32_TOL)
    for i, (jci, tci) in enumerate(zip(jc, tc)):
        assert tci["k"].shape == jci["k"].shape, i
        np.testing.assert_allclose(tci["k"].numpy(), np.asarray(jci["k"]),
                                   atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("arch,n_layers", [("granite-20b", None),
                                           ("gemma3-27b", 6)])
def test_decode_per_row_pos_and_active_match_jax_f32(arch, n_layers):
    """Continuous batching: per-row positions, rows that start late and
    an inactive row per step (the serving engine's calls)."""
    jm, jp, tm, tp = _models(arch, "float32", n_layers)
    b, s = 3, 44
    toks = np.random.default_rng(11).integers(0, tm.cfg.vocab_size, (b, s))
    start = np.array([0, 5, 9])
    # row r is active from step start[r] on, except every 7th step
    act = lambda t: (t >= start) & ((t + np.arange(b)) % 7 != 3)  # noqa: E731
    counts = np.zeros(b, np.int32)
    plan = []
    for t in range(s):
        plan.append(counts.copy())
        counts += act(t)
    jl, tl, jc, tc = _decode_both(jm, jp, tm, tp, toks, 64,
                                  lambda t: plan[t], act)
    for t in range(s):
        rows = act(t)
        np.testing.assert_allclose(tl[rows, t], jl[rows, t], atol=F32_TOL,
                                   rtol=F32_TOL)
    for jci, tci in zip(jc, tc):
        np.testing.assert_allclose(tci["v"].numpy(), np.asarray(jci["v"]),
                                   atol=F32_TOL, rtol=F32_TOL)


def test_decode_matches_jax_bf16():
    jm, jp, tm, tp = _models("gemma3-27b", "bfloat16", 6)
    toks = np.random.default_rng(2).integers(0, tm.cfg.vocab_size, (2, 40))
    jl, tl, _, _ = _decode_both(jm, jp, tm, tp, toks, 48,
                                lambda t: np.full(2, t, np.int32))
    np.testing.assert_allclose(tl, jl, atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("arch,n_layers,s", [("granite-20b", None, 16),
                                             ("gemma3-27b", 6, 64),
                                             ("phi3-mini-3.8b", None, 12),
                                             ("qwen1.5-110b", None, 12)])
def test_decode_matches_prefill_f32(arch, n_layers, s):
    """The port alone: teacher-forced decode logits equal the prefill
    logits (the check ``chip_smoke.py`` runs on the card, where JAX is
    absent), with the port's own weights."""
    changes = {"dtype": "float32"}
    if n_layers:
        changes["n_layers"] = n_layers
    cfg = dataclasses.replace(get_config(arch).smoke(), **changes)
    m = build_model(cfg, device="cpu")
    p = m.init(3)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, s)))
    full = m.forward(p, {"tokens": toks})
    caches = m.decode_init(2, s)
    outs = []
    for t in range(s):
        logits, caches = m.decode_step(p, caches, toks[:, t:t + 1], t)
        outs.append(logits)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=F32_TOL, rtol=F32_TOL)


def test_layer_metadata_and_caches_follow_the_pattern():
    cfg = dataclasses.replace(get_config("gemma3-27b"), n_layers=12)
    meta = T.layer_metadata(cfg)
    assert meta["window"] == [1024] * 5 + [None] + [1024] * 5 + [None]
    assert meta["theta"] == [1e4] * 5 + [1e6] + [1e4] * 5 + [1e6]
    jmeta = jax.tree.map(np.asarray, __import__(
        "repro.models.transformer", fromlist=["x"]).layer_metadata(cfg))
    assert [w if w is not None else -1 for w in meta["window"]] \
        == jmeta["window"].tolist()
    small = dataclasses.replace(get_config("gemma3-27b").smoke(), n_layers=6)
    caches = T.init_decode_state(small, 2, 100, "cpu")
    assert [c["k"].shape[2] for c in caches] == [32] * 5 + [100]


def test_init_draws_the_reference_shapes_and_stds():
    cfg = get_config("gemma3-27b").smoke()
    jcfg = jax_get_config("gemma3-27b").smoke()
    jp, _ = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tp = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    conv = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    flat_t = torch.utils._pytree.tree_flatten_with_path(tp)[0]
    flat_c = dict(torch.utils._pytree.tree_flatten_with_path(conv)[0])
    assert len(flat_t) == len(flat_c)
    for path, t in flat_t:
        c = flat_c[path]
        assert t.shape == c.shape and t.dtype == c.dtype, path
        if t.numel() > 1000:
            assert abs(t.std().item() / c.std().item() - 1) < 0.1, path


def test_entry_points_default_to_the_card():
    m = build_model(get_config("granite-20b").smoke())
    assert m.device.type == "cuda"
