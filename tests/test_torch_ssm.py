"""The port's Mamba-2 mixer (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``), on the CPU.

Inputs are drawn from a numpy seed; the mixer's parameters are drawn by
``repro``'s ``init_mamba2`` and carried over as numpy arrays, so both
packages compute the same function.

Tolerances (float32): atol = rtol = 2e-5 for the scan itself
(``ssd_chunked`` against ``ssd_ref``, and each against JAX's): the two
frameworks, and the chunked and sequential forms, sum the same f32
terms in another order (measured: at most 4.5e-6 on outputs of
magnitude ~8).  The whole block and its decode (projections, conv, norm)
are held at 1e-5 (measured: 5.1e-6).  bfloat16 compute: atol = rtol =
0.05 on the block's output of magnitude ~3.6, under two bf16 ulps there,
for the places where the frameworks may round the projections' and the
conv's outputs differently (measured: equal on the CPU).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402

SSD_TOL = 2e-5
BLOCK_TOL = 1e-5
BF16_TOL = 0.05


def _scan_inputs(b, s, H, P, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, size=(b, s, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32)
    B = rng.normal(size=(b, s, N)).astype(np.float32)
    C = rng.normal(size=(b, s, N)).astype(np.float32)
    return x, dt, A, B, C


# (s, chunk): a whole chunk, several, and s not a multiple of the chunk
SCAN_CASES = [(16, 16), (48, 16), (37, 8), (70, 32), (5, 5)]


@pytest.mark.parametrize("s,chunk", SCAN_CASES)
def test_ssd_chunked_matches_ref_and_jax(s, chunk):
    ins = _scan_inputs(2, s, 3, 4, 5, seed=s * 100 + chunk)
    t_ins = [torch.from_numpy(a) for a in ins]
    y, st = S.ssd_chunked(*t_ins, chunk=chunk)
    y_ref, st_ref = S.ssd_ref(*t_ins)
    assert y.shape == (2, s, 3, 4) and st.shape == (2, 3, 5, 4)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=SSD_TOL,
                               rtol=SSD_TOL)
    np.testing.assert_allclose(st.numpy(), st_ref.numpy(), atol=SSD_TOL,
                               rtol=SSD_TOL)
    j_ins = [jnp.asarray(a) for a in ins]
    jy, jst = JS.ssd_chunked(*j_ins, chunk=chunk)
    jy_ref, _ = JS.ssd_ref(*j_ins)
    for want in (np.asarray(jy), np.asarray(jy_ref)):
        np.testing.assert_allclose(y.numpy(), want, atol=SSD_TOL,
                                   rtol=SSD_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=SSD_TOL,
                               rtol=SSD_TOL)


def test_ssd_gradient_is_finite_at_a_full_chunk():
    """At a full chunk of 256 with the decay of the models' init (dt * A
    ~ -0.7 a token), the upper triangle's exponents reach +180: exp
    overflows to inf there.  The port masks before the exp, so its
    gradient is finite and equals the recurrence's (autograd through
    ``ssd_ref``) within 1e-3 of each gradient's largest; the reference
    takes exp first, so ``jax.grad`` of its ``ssd_chunked`` is NaN (a
    reference caveat, ROADMAP.md Queue 3).  Forward: within 1e-4
    (measured 2.3e-5; the chunked form multiplies exp(+-180)-scale
    factors that the recurrence never forms)."""
    x, dt, A, B, C = _scan_inputs(1, 256, 2, 4, 3, seed=7)
    dt, A = dt * 2, A * 2
    t = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    leaves = {}
    for name, fn in (("chunked", lambda *a: S.ssd_chunked(*a, chunk=256)),
                     ("ref", S.ssd_ref)):
        dtt, At = (v.clone().requires_grad_() for v in (t[1], t[2]))
        y, _ = fn(t[0], dtt, At, t[3], t[4])
        y.square().sum().backward()
        leaves[name] = (y.detach(), dtt.grad, At.grad)
    (y, g_dt, g_A), (y_ref, r_dt, r_A) = leaves["chunked"], leaves["ref"]
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=1e-4,
                               rtol=1e-4)
    for g, r in ((g_dt, r_dt), (g_A, r_A)):
        assert torch.isfinite(g).all()
        assert float((g - r).abs().max()) <= 1e-3 * float(r.abs().max())
    jg = jax.grad(lambda d, a: jnp.sum(JS.ssd_chunked(
        jnp.asarray(x), d, a, jnp.asarray(B), jnp.asarray(C),
        chunk=256)[0] ** 2))(jnp.asarray(dt), jnp.asarray(A))
    assert not np.isfinite(np.asarray(jg)).all()


def _cfg(dtype="float32", arch="mamba2-780m"):
    jcfg = dataclasses.replace(jax_get_config(arch).smoke(), dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch).smoke(), dtype=dtype)
    return jcfg, tcfg


def _mixer(jcfg, seed=0):
    jp, _ = JS.init_mamba2(jax.random.PRNGKey(seed), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jp, tp


def test_init_matches_the_reference_shapes_and_constants():
    jcfg, tcfg = _cfg()
    jp, _ = _mixer(jcfg)
    tp = S.init_mamba2(torch.Generator().manual_seed(0), tcfg)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert torch.equal(tp["A_log"], torch.full_like(tp["A_log"], 0.5))
    assert torch.equal(tp["D"], torch.ones_like(tp["D"]))
    np.testing.assert_array_equal(tp["D"].numpy(), np.asarray(jp["D"]))
    np.testing.assert_array_equal(tp["A_log"].numpy(),
                                  np.asarray(jp["A_log"]))


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
@pytest.mark.parametrize("s,chunk", [(24, 256), (40, 16)])
def test_mamba2_block_matches_jax_f32(arch, s, chunk):
    jcfg, tcfg = _cfg(arch=arch)
    jp, tp = _mixer(jcfg, seed=s)
    u = np.random.default_rng(s).normal(
        size=(2, s, tcfg.d_model)).astype(np.float32)
    want = np.asarray(JS.mamba2_block(jp, jnp.asarray(u), jcfg, jnp.float32,
                                      chunk=chunk))
    got = S.mamba2_block(tp, torch.from_numpy(u), tcfg, torch.float32,
                         chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, atol=BLOCK_TOL,
                               rtol=BLOCK_TOL)


def test_mamba2_block_matches_jax_bf16():
    jcfg, tcfg = _cfg("bfloat16")
    jp, tp = _mixer(jcfg, seed=3)
    u = np.random.default_rng(3).normal(
        size=(2, 40, tcfg.d_model)).astype(np.float32)
    want = np.asarray(JS.mamba2_block(
        jp, jnp.asarray(u, jnp.bfloat16), jcfg, jnp.bfloat16, chunk=16),
        np.float32)
    got = S.mamba2_block(tp, torch.from_numpy(u).bfloat16(), tcfg,
                         torch.bfloat16, chunk=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL,
                               rtol=BF16_TOL)


def test_mamba2_decode_with_a_partial_active_mask_matches_jax():
    """Teacher-forced decode of 3 rows, one of them inactive at some
    steps: outputs, state and conv history equal JAX's at every step, and
    an inactive row keeps both its state and its conv history."""
    jcfg, tcfg = _cfg()
    jp, tp = _mixer(jcfg, seed=5)
    b, s = 3, 12
    u = np.random.default_rng(5).normal(
        size=(b, s, tcfg.d_model)).astype(np.float32)
    jc, _ = JS.init_ssm_cache(jcfg, b, jnp.float32)
    tc = S.init_ssm_cache(tcfg, b, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    for t in range(s):
        act = np.array([True, t % 3 != 1, t >= 4])
        jy, jc = JS.mamba2_decode(jp, jnp.asarray(u[:, t:t + 1]), jc, jcfg,
                                  jnp.float32, active=jnp.asarray(act))
        before = {k: v.clone() for k, v in tc.items()}
        ty, tc = S.mamba2_decode(tp, torch.from_numpy(u[:, t:t + 1]), tc,
                                 tcfg, torch.float32,
                                 active=torch.from_numpy(act))
        np.testing.assert_allclose(ty[act].numpy(), np.asarray(jy)[act],
                                   atol=BLOCK_TOL, rtol=BLOCK_TOL)
        for k in ("state", "conv"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       atol=BLOCK_TOL, rtol=BLOCK_TOL)
            assert torch.equal(tc[k][~torch.from_numpy(act)],
                               before[k][~torch.from_numpy(act)])


def test_mamba2_decode_matches_the_block():
    """The recurrence (decode) against the chunked scan (the block) over
    more than two chunks, in the port alone."""
    _, tcfg = _cfg()
    tp = S.init_mamba2(torch.Generator().manual_seed(2), tcfg)
    u = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 37, tcfg.d_model)).astype(np.float32))
    full = S.mamba2_block(tp, u, tcfg, torch.float32, chunk=16)
    cache = S.init_ssm_cache(tcfg, 2, torch.float32, "cpu")
    outs = []
    for t in range(u.shape[1]):
        y, cache = S.mamba2_decode(tp, u[:, t:t + 1], cache, tcfg,
                                   torch.float32)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               atol=BLOCK_TOL, rtol=BLOCK_TOL)
