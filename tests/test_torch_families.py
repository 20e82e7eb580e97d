"""The moe, vlm, ssm, hybrid and audio families of the port against the
JAX package's, on the CPU, through the public entry points.

For each of the six archs of those families (``dbrx-132b``,
``granite-moe-1b-a400m``, ``llava-next-mistral-7b``, ``mamba2-780m``,
``hymba-1.5b``, ``whisper-small``) at its ``smoke()`` config: the same
parameters (drawn by ``repro``'s init, carried over by
``params_from_jax``) and the same numpy batches go through
``repro.models.registry.build_model`` and
``repro_torch.models.registry.build_model``; ``forward``, teacher-forced
``decode_step`` (per-row ``pos``, an ``active`` mask) and ``loss`` with
the gradient of every parameter are compared.  Then the port alone:
decode equals prefill; its own ``init`` draws the reference's tree;
``ServingEngine`` gives JAX's greedy tokens on a stream that reuses
slots.

Tolerances:
- float32: atol = rtol = 2e-4 for logits, loss and gradients, the
  reference's own decode-vs-prefill tolerance
  (``tests/test_arch_smoke.py``); the two packages sum in different f32
  orders (measured: logits within 6.6e-6, losses 9.5e-7, gradients
  1.6e-7).
- bfloat16 forward and decode: atol = rtol = 0.1 on logits of unit
  scale, the bound ``tests/test_torch_models.py`` states and justifies
  (the frameworks round to bf16 at different places, and the roundings
  compound over the layers; measured: 0.043 (forward) and 0.040
  (decode) on logits up to 4.7).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.registry import build_model as jax_build  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

F32_TOL = 2e-4
BF16_TOL = 0.1
ARCHS = ["dbrx-132b", "granite-moe-1b-a400m", "llava-next-mistral-7b",
         "mamba2-780m", "hymba-1.5b", "whisper-small"]
B, S = 2, 32

_MODELS = {}


def _models(arch, dtype="float32", seed=0):
    key = (arch, dtype, seed)
    if key not in _MODELS:
        jcfg = dataclasses.replace(jax_get_config(arch).smoke(), dtype=dtype)
        tcfg = dataclasses.replace(get_config(arch).smoke(), dtype=dtype)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        jm = jax_build(jcfg)
        jp, _ = jm.init(jax.random.PRNGKey(seed))
        tm = build_model(tcfg, device="cpu")
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
        _MODELS[key] = (jm, jp, tm, tp)
    return _MODELS[key]


def _batch(cfg, seed):
    """``tests/test_arch_smoke.py``'s batch: audio gets S frames and S/4
    text tokens, a vlm n_patches patches and S - n_patches tokens."""
    rng = np.random.default_rng(seed)
    s_txt = {"audio": S // 4, "vlm": S - cfg.n_patches}.get(cfg.family, S)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, s_txt)),
           "labels": rng.integers(-1, cfg.vocab_size, (B, s_txt))}
    if cfg.family == "audio":
        out["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.normal(
            size=(B, cfg.n_patches, cfg.d_vision)).astype(np.float32)
    return out


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax_f32(arch):
    jm, jp, tm, tp = _models(arch)
    batch = _batch(tm.cfg, 1)
    want = np.asarray(jm.forward(jp, _jb(batch)))
    got = tm.forward(tp, _tb(batch))
    assert got.dtype == torch.float32 and got.shape == want.shape
    n_prefix = tm.cfg.n_patches if tm.cfg.family == "vlm" else 0
    assert got.shape == (B, batch["tokens"].shape[1] + n_prefix,
                         tm.cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax_bf16(arch):
    jm, jp, tm, tp = _models(arch, "bfloat16")
    batch = _batch(tm.cfg, 2)
    want = np.asarray(jm.forward(jp, _jb(batch)), np.float32)
    got = tm.forward(tp, _tb(batch))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL,
                               rtol=BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_per_row_pos_and_active_match_jax_f32(arch):
    """Continuous batching: per-row positions, rows that start late and
    an inactive row per step (the serving engine's calls).  The cache of
    every layer (k / v, the SSM state and conv history) ends equal."""
    jm, jp, tm, tp = _models(arch)
    b, s = 3, 14
    toks = np.random.default_rng(11).integers(0, tm.cfg.vocab_size, (b, s))
    start = np.array([0, 3, 6])
    act_at = lambda t: (t >= start) & ((t + np.arange(b)) % 5 != 2)  # noqa
    jc, _ = jm.decode_init(b, 24)
    tc = tm.decode_init(b, 24)
    jstep = jax.jit(lambda p, c, t, pos, act: jm.decode_step(
        p, c, t, pos, active=act))
    pos = np.zeros(b, np.int32)
    for t in range(s):
        act = act_at(t)
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                       jnp.asarray(pos), jnp.asarray(act))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]),
                                torch.from_numpy(pos), torch.from_numpy(act))
        np.testing.assert_allclose(tl[act].numpy(), np.asarray(jl)[act],
                                   atol=F32_TOL, rtol=F32_TOL)
        pos = pos + act
    want = jax.tree.leaves(jc)
    got = tree_leaves(tc)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F32_TOL,
                                   rtol=F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax_bf16(arch):
    """Batch-synchronous bf16 decode: the caches and the SSM conv history
    in bf16, the SSM state in f32, as in the reference."""
    jm, jp, tm, tp = _models(arch, "bfloat16")
    b, s = 2, 16
    toks = np.random.default_rng(2).integers(0, tm.cfg.vocab_size, (b, s))
    jc, _ = jm.decode_init(b, 24)
    tc = tm.decode_init(b, 24)
    jstep = jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, t, pos))
    for t in range(s):
        pos = np.full(b, t, np.int32)
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                       jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]),
                                torch.from_numpy(pos))
        assert tl.dtype == torch.bfloat16
        np.testing.assert_allclose(tl.float().numpy(),
                                   np.asarray(jl, np.float32),
                                   atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_f32(arch):
    """``loss`` (a vlm's prefix dropped, moe's ``0.01 * aux`` added) and
    the gradient of every parameter against ``jax.value_and_grad``."""
    jm, jp, tm, tp = _models(arch)
    batch = _batch(tm.cfg, 3)
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss(p, _jb(batch)), has_aux=True)(jp)
    live = tree_map(lambda p: p.detach().requires_grad_(), tp)
    tl, tmet = tm.loss(live, _tb(batch))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=F32_TOL,
                               rtol=F32_TOL)
    assert float(tmet["tokens"]) == float(jmet["tokens"])
    if tm.cfg.family == "moe":
        aux = float(tmet["aux"].detach())
        assert aux > 0
        np.testing.assert_allclose(aux, float(jmet["aux"]), atol=F32_TOL,
                                   rtol=F32_TOL)
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jg),
                                       tm.cfg))
    # a leaf the loss never reads (hybrid's ln_ssm: both mixers read the
    # ln_attn-normed input, as in the reference) gets None here, zeros there
    got = [torch.zeros_like(p) if p.grad is None else p.grad
           for p in tree_leaves(live)]
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=F32_TOL,
                                   rtol=F32_TOL)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "llava-next-mistral-7b", "mamba2-780m",
                                  "hymba-1.5b"])
def test_decode_matches_prefill_f32(arch):
    """The port alone (the check ``chip_smoke.py`` runs on the card,
    where JAX is absent): teacher-forced decode logits equal the prefill
    logits, with the port's own weights (text only for the vlm)."""
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    m = build_model(cfg, device="cpu")
    p = m.init(3)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 40)))
    full = m.forward(p, {"tokens": toks})
    caches = m.decode_init(2, 40)
    outs = []
    for t in range(toks.shape[1]):
        logits, caches = m.decode_step(p, caches, toks[:, t:t + 1], t)
        outs.append(logits)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_the_reference_tree(arch):
    """The port's own ``init``: the reference's tree (paths, shapes,
    dtypes), the same stds where a leaf is large enough to tell."""
    _, _, tm, conv = _models(arch)
    own = tm.init(torch.Generator().manual_seed(0))
    flat_o = torch.utils._pytree.tree_flatten_with_path(own)[0]
    flat_c = dict(torch.utils._pytree.tree_flatten_with_path(conv)[0])
    assert len(flat_o) == len(flat_c)
    for path, t in flat_o:
        c = flat_c[path]
        assert t.shape == c.shape and t.dtype == c.dtype, path
        if t.numel() > 1000 and float(c.std()) > 0:
            assert abs(t.std().item() / c.std().item() - 1) < 0.1, path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_reference_arch_has_its_config(arch):
    assert ARCH_IDS == JAX_ARCH_IDS
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))


def test_a_family_the_reference_does_not_know_raises():
    cfg = dataclasses.replace(get_config("granite-20b").smoke(),
                              family="rnn")
    with pytest.raises(ValueError, match="rnn"):
        build_model(cfg, device="cpu")


def _serve(engine_cls, request_cls, model, params, reqs, **kw):
    eng = engine_cls(model, params, **kw)
    for rid, prompt, max_new in reqs:
        eng.submit(request_cls(rid=rid, prompt=prompt,
                               max_new_tokens=max_new))
    done = eng.run_until_drained(max_steps=500)
    eng.close()
    return done


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_engine_matches_jax_engine_f32(arch):
    """7 requests on 3 slots, so that four of them start in a freed
    slot: the port, like the reference, resets the slot's position but
    not its SSM state and conv history, and both give the same greedy
    tokens (ROADMAP.md Queue 3, reference caveats)."""
    jm, jp, tm, tp = _models(arch)
    rng = np.random.default_rng(1)
    reqs = [(rid, rng.integers(1, tm.cfg.vocab_size,
                               size=int(rng.integers(2, 10))), 6)
            for rid in range(7)]
    kw = dict(batch=3, kv_len=32)
    jdone = _serve(JEngine, JRequest, jm, jp, reqs, **kw)
    tdone = _serve(ServingEngine, Request, tm, tp, reqs, **kw)
    assert sorted(tdone) == sorted(jdone) == list(range(7))
    for rid in jdone:
        assert tdone[rid].out_tokens == jdone[rid].out_tokens, rid
        assert len(tdone[rid].out_tokens) == 6
