"""The flash-attention wrapper's plan on the CPU: which route a dtype
takes, how a head_dim is padded, bucketed and tiled, and that the
padding of the bf16 route changes no result.

The bf16 route hands TMA rows of a multiple of 8 elements (16-byte
strides), so q, k and v are zero-padded along head_dim and ``scale``
stays the true head_dim's; the zero columns add nothing to q . k, and
the padded columns of the output are sliced off.  Here that path runs
through the plain version (f32, atol = rtol = 1e-6: the zero terms are
exact, only the summation blocking may differ) and against the JAX
package's Pallas kernel in interpret mode (the reference tests' 2e-5).
The kernels themselves are held against the plain version on the card
in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.kernels.flash_attention as jax_fa  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

PAD_TOL = 1e-6
F32_TOL = 2e-5   # tests/test_kernels.py


@pytest.mark.parametrize("dh,dh_pad,bucket,block_k", [
    (1, 8, 64, 128), (8, 8, 64, 128), (36, 40, 64, 128), (64, 64, 64, 128),
    (65, 72, 128, 128), (96, 96, 128, 128), (128, 128, 128, 128),
    (130, 136, 256, 64), (200, 200, 256, 64), (256, 256, 256, 64)])
def test_bf16_takes_the_tensor_core_route(dh, dh_pad, bucket, block_k):
    p = fa.plan(torch.bfloat16, dh)
    assert p == fa.FlashPlan("wgmma", "flash_attention_sm90", dh_pad, bucket,
                             128, block_k)
    assert p.dh_pad % 8 == 0 and p.dh_pad - dh < 8 and p.dh_pad <= p.bucket


@pytest.mark.parametrize("dh,bucket", [(1, 64), (36, 64), (64, 64),
                                       (65, 128), (128, 128), (150, 192),
                                       (200, 256), (256, 256)])
def test_f32_takes_the_cuda_core_route(dh, bucket):
    assert fa.plan(torch.float32, dh) == fa.FlashPlan(
        "simt", "flash_attention", dh, bucket, 64, 64)


def test_plan_refuses_what_no_route_takes():
    with pytest.raises(TypeError):
        fa.plan(torch.float16, 64)
    for dh in (0, 257):
        with pytest.raises(ValueError, match="head_dim"):
            fa.plan(torch.bfloat16, dh)


def test_routes_are_entry_points_counted_under_one_kernel():
    assert set(_build.SIGNATURES) == set(ops.KERNELS) | {
        "lsh_hash_resolve", "flash_attention_sm90", "bucket_insert_pass"}
    assert _build.ROUTE_OF == {
        "lsh_hash_resolve": ("lsh_hash",),
        "flash_attention_sm90": ("flash_attention",),
        "bucket_insert_pass": ("slot_counts", "bucket_core_stats")}
    for dtype in (torch.float32, torch.bfloat16):
        assert fa.plan(dtype, 64).entry in _build.SIGNATURES
    assert set(ops.launch_counts()) == set(ops.KERNELS)
    assert set(ops.entry_launch_counts()) == set(_build.SIGNATURES)


def _qkv(b, hq, hkv, sq, skv, dh, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((b, hq, sq, dh), (b, hkv, skv, dh), (b, hkv, skv, dh))]


def test_pad_head_dim_appends_zero_columns():
    x = torch.randn(2, 3, 5, 36).to(torch.bfloat16)
    y = fa.pad_head_dim(x, 40)
    assert y.shape == (2, 3, 5, 40) and y.is_contiguous()
    assert torch.equal(y[..., :36], x)
    assert not y[..., 36:].any()
    assert fa.pad_head_dim(x, 36) is x  # already a multiple of 8


@pytest.mark.parametrize("case", [
    (1, 4, 2, 77, 77, 36, True, None, 0),
    (2, 3, 1, 50, 90, 36, True, 16, 40),
    (1, 2, 2, 1, 64, 12, True, None, 63),
    (1, 2, 1, 40, 40, 65, False, None, 0),
    (1, 2, 1, 33, 33, 130, True, 8, 0),
], ids=str)
def test_padded_path_equals_unpadded_plain_version(case):
    b, hq, hkv, sq, skv, dh, causal, window, q_off = case
    q, k, v = _qkv(b, hq, hkv, sq, skv, dh, sq + dh)
    dh_pad = fa.plan(torch.bfloat16, dh).dh_pad
    assert dh_pad > dh
    kw = {"causal": causal, "window": window, "q_offset": q_off}
    got = ref.attention(*(fa.pad_head_dim(t, dh_pad) for t in (q, k, v)),
                        scale=dh ** -0.5, **kw)
    assert got.shape == (b, hq, sq, dh_pad)
    assert not got[..., dh:].any()
    torch.testing.assert_close(got[..., :dh], ref.attention(q, k, v, **kw),
                               atol=PAD_TOL, rtol=PAD_TOL)


def test_padded_path_matches_the_pallas_kernel():
    """dh = 36 padded to 40 with the true scale, against the TPU kernel
    on the unpadded inputs in interpret mode."""
    q, k, v = _qkv(1, 4, 2, 40, 40, 36, 7)
    want = jax_fa.flash_attention(q.numpy(), k.numpy(), v.numpy(),
                                  window=16, block_q=16, block_k=16,
                                  interpret=True)
    got = ref.attention(*(fa.pad_head_dim(t, 40) for t in (q, k, v)),
                        window=16, scale=36 ** -0.5)[..., :36]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)


def test_bf16_padding_on_the_cpu_stays_within_an_ulp():
    q, k, v = (t.to(torch.bfloat16)
               for t in _qkv(1, 4, 2, 30, 30, 36, 3))
    got = ref.attention(*(fa.pad_head_dim(t, 40) for t in (q, k, v)),
                        window=8, scale=36 ** -0.5)[..., :36]
    want = ops.attention(q, k, v, window=8)
    torch.testing.assert_close(got.float(), want.float(), atol=2 ** -7,
                               rtol=2 ** -7)
