"""The port's plain attention against the JAX package's, on the CPU.

``repro_torch.kernels.ref.attention`` (what ``ops.attention`` runs on a
CPU tensor, and what the CUDA flash-attention kernel is held against on
the card) is compared with ``repro.kernels.ref.attention`` and with the
Pallas ``flash_attention`` in interpret mode, on the cases of
``tests/test_kernels.py``'s flash-attention tests, at their tolerances:
atol = rtol = 2e-5 in float32, 2e-2 in bfloat16.  The port's plain
version and ``repro.kernels.ref`` do the same operations, but XLA's and
torch's f32 sums run in different orders; the Pallas kernel sums in
blocks (online softmax).

The CUDA kernel itself is held against this plain version on the card
in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.kernels.flash_attention as jax_fa  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# tests/test_kernels.py's flash-attention cases, plus gemma3-like GQA
# with a window, head_dim 16 / 96 / 128 and ragged lengths
CASES = [
    (1, 2, 2, 64, 64, 32, True, None),
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 4, 1, 96, 96, 32, True, None),       # MQA, non-multiple seq
    (1, 2, 2, 64, 64, 32, True, 16),         # sliding window
    (2, 2, 2, 1, 128, 32, True, None),       # decode: 1 query token
    (1, 2, 2, 64, 64, 32, False, None),      # bidirectional (encoder)
    (1, 4, 2, 100, 100, 16, True, 32),       # smoke gemma3: dh 16, window
    (1, 4, 2, 70, 70, 96, True, None),       # dh 96, ragged
    (1, 4, 2, 130, 130, 128, True, 48),      # dh 128, window, ragged
    (2, 4, 2, 33, 161, 128, True, 64),       # q_offset 128, window
]
F32_TOL = 2e-5
BF16_TOL = 2e-2


def _qkv(b, hq, hkv, sq, skv, dh):
    rng = np.random.default_rng(hq * sq + skv + dh)
    q = rng.normal(size=(b, hq, sq, dh)).astype(np.float32)
    k = rng.normal(size=(b, hkv, skv, dh)).astype(np.float32)
    v = rng.normal(size=(b, hkv, skv, dh)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal,window", CASES)
def test_plain_attention_matches_jax_ref(b, hq, hkv, sq, skv, dh, causal,
                                         window):
    q, k, v = _qkv(b, hq, hkv, sq, skv, dh)
    q_off = skv - sq if causal else 0
    want = jax_ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window, q_offset=q_off)
    got = ops.attention(*_t(q, k, v), causal=causal, window=window,
                        q_offset=q_off)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal,window", CASES)
def test_plain_attention_matches_pallas_interpret(b, hq, hkv, sq, skv, dh,
                                                  causal, window):
    q, k, v = _qkv(b, hq, hkv, sq, skv, dh)
    q_off = skv - sq if causal else 0
    want = jax_fa.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_off, block_q=32, block_k=32,
                                  interpret=True)
    got = ref.attention(*_t(q, k, v), causal=causal, window=window,
                        q_offset=q_off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_dtypes(dtype):
    """As ``tests/test_kernels.py::test_flash_attention_dtypes``: the
    output keeps the input dtype and agrees with both JAX versions."""
    rng = np.random.default_rng(0)
    arrs = [rng.normal(size=(1, 2, 64, 32)) for _ in range(3)]
    jarrs = [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrs]
    tdt = getattr(torch, dtype)
    # the same values in both frameworks (bf16 rounding of the inputs)
    targs = [torch.from_numpy(np.array(a, np.float32)).to(tdt)
             for a in jarrs]
    got = ops.attention(*targs)
    assert got.dtype == tdt
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for want in (jax_ref.attention(*jarrs),
                 jax_fa.flash_attention(*jarrs, block_q=32, block_k=32,
                                        interpret=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


def test_plain_attention_bf16_rounds_the_logits():
    """For bf16 inputs the logits einsum runs in bf16 and is then cast to
    f32, as in ``repro.kernels.ref``: the result equals the f32 version
    run on bf16-rounded logits, not on f32 logits."""
    rng = np.random.default_rng(4)
    q, k, v = [torch.from_numpy(rng.normal(size=(1, 2, 16, 8)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3)]
    got = ref.attention(q, k, v)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * (8 ** -0.5)
    mask = torch.ones(16, 16, dtype=torch.bool).tril()
    p = torch.softmax(logits.masked_fill(~mask, ref.NEG_INF), -1)
    want = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16), v)
    assert torch.equal(got, want)


def test_long_decode_row_matches_jax():
    """Decode shape: one query against a long KV with GQA grouping
    (``tests/test_kernels.py::test_flash_attention_long_decode_row``)."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 8, 1, 64)).astype(np.float32)
    k = rng.normal(size=(2, 2, 512, 64)).astype(np.float32)
    v = rng.normal(size=(2, 2, 512, 64)).astype(np.float32)
    want = jax_fa.flash_attention(q, k, v, q_offset=511, block_q=1,
                                  block_k=128, interpret=True)
    got = ops.attention(*_t(q, k, v), q_offset=511)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)


def test_ops_dispatch_by_device():
    q, k, v = _t(*_qkv(1, 2, 1, 8, 8, 16))
    before = ops.launch_counts()["flash_attention"]
    assert torch.equal(ops.attention(q, k, v, window=4),
                       ops.attention(q, k, v, window=4, impl="ref"))
    # a CPU tensor runs the plain version and counts no launch
    assert ops.launch_counts()["flash_attention"] == before
    with pytest.raises(ValueError, match="impl"):
        ops.attention(q, k, v, impl="pallas")
    # the CUDA wrapper refuses a tensor that is not on the card
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention(q, k, v)
