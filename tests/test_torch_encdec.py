"""The port's encoder-decoder (``repro_torch.models.encdec``) and GELU
MLP against the JAX package's (``repro.models.encdec``,
``repro.models.layers.gelu_mlp``), on the CPU.

``whisper-small``'s smoke config (2 + 2 layers, d_model 64, 4 query
heads on 2 kv heads).  Parameters are drawn by ``repro``'s
``init_encdec`` and carried over by ``params_from_jax``; frames and
tokens come from a numpy seed.

Tolerances: float32 at atol = rtol = 2e-4, the reference's own
decode-vs-prefill tolerance (``tests/test_arch_smoke.py``); the GELU MLP
and the sinusoid alone at 1e-5 (one op each; the frameworks' tanh and
sin / cos differ in the last ulps).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import encdec as JED  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

F32_TOL = 2e-4
OP_TOL = 1e-5

_MODEL = []


def _model():
    """whisper-small's smoke config in f32 and its parameters, in both
    packages (built once)."""
    if not _MODEL:
        jcfg = dataclasses.replace(jax_get_config("whisper-small").smoke(),
                                   dtype="float32")
        tcfg = dataclasses.replace(get_config("whisper-small").smoke(),
                                   dtype="float32")
        jp, _ = JED.init_encdec(jcfg, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
        _MODEL.append((jcfg, tcfg, jp, tp))
    return _MODEL[0]


def _frames_tokens(cfg, seed, b=2, s_frames=24, s_txt=10):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(b, s_frames, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (b, s_txt))
    return frames, toks


def test_sinusoid_matches_jax():
    pos = np.arange(300)[None]
    np.testing.assert_allclose(
        ED._sinusoid(torch.from_numpy(pos), 64).numpy(),
        np.asarray(JED._sinusoid(jnp.asarray(pos), 64)), atol=OP_TOL,
        rtol=OP_TOL)


def test_gelu_mlp_matches_jax_tanh_gelu():
    """``jax.nn.gelu`` is the tanh approximation; torch's exact default
    differs by 6.1e-4 here (measured), the port by 4.8e-7."""
    jp, _ = JL.init_gelu_mlp(jax.random.PRNGKey(1), 64, 128)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    jp = dict(jp, b_in=jnp.asarray(np.random.default_rng(0).normal(
        size=128).astype(np.float32)))
    tp["b_in"] = torch.from_numpy(np.array(jp["b_in"]))
    x = np.random.default_rng(1).normal(size=(3, 5, 64)).astype(np.float32)
    want = np.asarray(JL.gelu_mlp(jp, jnp.asarray(x), jnp.float32))
    got = L.gelu_mlp(tp, torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=OP_TOL, rtol=OP_TOL)
    tp0 = L.init_gelu_mlp(torch.Generator().manual_seed(0), 64, 128)
    assert {k: tuple(v.shape) for k, v in tp0.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}


def test_encode_and_decode_train_match_jax():
    jcfg, tcfg, jp, tp = _model()
    frames, toks = _frames_tokens(tcfg, 2)
    jenc = JED.encode(jp, jcfg, jnp.asarray(frames))
    tenc = ED.encode(tp, tcfg, torch.from_numpy(frames))
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), atol=F32_TOL,
                               rtol=F32_TOL)
    jl = JED.decode_train(jp, jcfg, jnp.asarray(toks), jenc)
    tl = ED.decode_train(tp, tcfg, torch.from_numpy(toks), tenc)
    assert tl.shape == (2, 10, tcfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("cross", ["zeros", "encoded"])
def test_decode_step_matches_jax(cross):
    """Teacher-forced decode with per-row positions and an inactive row,
    against zero cross caches (what ``serve`` hands whisper) and against
    the encoder's k / v of real frames (cut to the smoke length)."""
    jcfg, tcfg, jp, tp = _model()
    frames, toks = _frames_tokens(tcfg, 3, s_txt=9)
    b, s = toks.shape
    jc, _ = JED.init_decode_state(jcfg, b, 16, cross_len=24)
    tc = ED.init_decode_state(tcfg, b, 16, "cpu", cross_len=24)
    if cross == "encoded":
        enc = JED.encode(jp, jcfg, jnp.asarray(frames))
        for i in range(jcfg.n_layers):
            lp = jax.tree.map(lambda v: v[i], jp["dec_layers"])
            k, v = JED._enc_kv(lp["cross"], enc, jnp.float32)
            jc[i] = dict(jc[i], xk=k, xv=v)
            tc[i] = dict(tc[i], xk=torch.from_numpy(np.array(k)),
                         xv=torch.from_numpy(np.array(v)))
    step = jax.jit(lambda p, c, t, pos, act: JED.encdec_decode_step(
        p, jcfg, c, t, pos, active=act))
    pos = np.zeros(b, np.int32)
    for t in range(s):
        act = np.array([True, t != 4])
        jlog, jc = step(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                        jnp.asarray(pos), jnp.asarray(act))
        tlog, tc = ED.encdec_decode_step(
            tp, tcfg, tc, torch.from_numpy(toks[:, t:t + 1]),
            torch.from_numpy(pos), torch.from_numpy(act))
        np.testing.assert_allclose(tlog[act].numpy(),
                                   np.asarray(jlog)[act], atol=F32_TOL,
                                   rtol=F32_TOL)
        pos = pos + act
    for jci, tci in zip(jc, tc):
        np.testing.assert_allclose(tci["k"].numpy(), np.asarray(jci["k"]),
                                   atol=F32_TOL, rtol=F32_TOL)


def test_decode_matches_decode_train_in_the_port():
    """The port alone: with the cross caches filled from the encoder,
    teacher-forced decode gives the full-sequence decoder's logits (the
    audio mirror of ``tests/test_arch_smoke.py``'s decode-vs-prefill)."""
    _, tcfg, _, tp = _model()
    frames, toks = _frames_tokens(tcfg, 4, s_txt=12)
    frames, toks = torch.from_numpy(frames), torch.from_numpy(toks)
    enc = ED.encode(tp, tcfg, frames)
    full = ED.decode_train(tp, tcfg, toks, enc)
    caches = ED.init_decode_state(tcfg, 2, 12, "cpu", cross_len=24)
    for c, lp in zip(caches, tp["dec_layers"]):
        c["xk"], c["xv"] = ED._enc_kv(lp["cross"], enc, torch.float32)
    outs = []
    for t in range(toks.shape[1]):
        logits, caches = ED.encdec_decode_step(tp, tcfg, caches,
                                               toks[:, t:t + 1], t)
        outs.append(logits)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=F32_TOL, rtol=F32_TOL)


def test_decode_state_holds_whispers_cross_caches():
    """Self caches of ``kv_len`` and cross caches of ``CROSS_LEN`` frames
    per decoder layer, as the reference's ``init_decode_state``."""
    jcfg, tcfg, _, _ = _model()
    jc, _ = JED.init_decode_state(jcfg, 3, 20)
    tc = ED.init_decode_state(tcfg, 3, 20, "cpu")
    assert [{k: tuple(v.shape) for k, v in c.items()} for c in tc] == \
        [{k: tuple(v.shape) for k, v in c.items()} for c in jc]
    assert tc[0]["xk"].shape[2] == ED.CROSS_LEN
