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

import re

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


@pytest.mark.parametrize("dh,dh_pad,bucket", [
    (1, 8, 64), (16, 16, 64), (36, 40, 64), (64, 64, 64), (65, 72, 128),
    (96, 96, 128), (128, 128, 128)])
def test_bf16_backward_takes_the_kernel(dh, dh_pad, bucket):
    assert fa.bwd_plan(torch.bfloat16, dh) == "wgmma"
    p = fa.plan(torch.bfloat16, dh)
    assert (p.dh_pad, p.bucket) == (dh_pad, bucket)


@pytest.mark.parametrize("dtype,dh", [
    (torch.bfloat16, 129), (torch.bfloat16, 130), (torch.bfloat16, 256),
    (torch.float32, 8), (torch.float32, 64), (torch.float32, 128)])
def test_f32_and_the_256_bucket_keep_the_plain_backward(dtype, dh):
    assert fa.bwd_plan(dtype, dh) == "plain"
    if dtype == torch.bfloat16:
        assert fa.plan(dtype, dh).dh_pad > 128


def test_bwd_plan_refuses_what_no_route_takes():
    with pytest.raises(TypeError):
        fa.bwd_plan(torch.float16, 64)
    for dh in (0, 257):
        with pytest.raises(ValueError, match="head_dim"):
            fa.bwd_plan(torch.bfloat16, dh)


@pytest.mark.parametrize("b,hq,hkv,skv,want", [
    (8, 48, 1, 1024, 6),    # granite-20b, cell 1: 64 blocks unsplit
    (2, 48, 1, 4096, 6),    # cell 3: 64 blocks unsplit
    (8, 16, 8, 4096, 1),    # granite-moe, cell 2: 2,048 blocks already
    (1, 5, 1, 128, 5),      # one head a slice at most
    (4, 48, 1, 1024, 10),   # the mesh step's local block
    (1, 1, 1, 1, 1),
])
def test_kv_splits_fill_the_card_without_empty_slices(b, hq, hkv, skv, want):
    n = fa.kv_splits(b, hq, hkv, skv, 132)
    assert n == want
    group = hq // hkv
    per = -(-group // n)
    assert (n - 1) * per < group  # the last slice has a head
    tiles = -(-skv // fa.BWD_BLOCK_K)
    assert b * hkv * tiles * n >= min(
        2 * 132, b * hkv * tiles * group)


def test_lse_rows_round_to_the_query_tile():
    assert [fa.lse_rows(s) for s in (1, 127, 128, 129, 4096)] == [
        128, 128, 128, 256, 4096]


def test_plan_refuses_what_no_route_takes():
    with pytest.raises(TypeError):
        fa.plan(torch.float16, 64)
    for dh in (0, 257):
        with pytest.raises(ValueError, match="head_dim"):
            fa.plan(torch.bfloat16, dh)


def test_routes_are_entry_points_counted_under_one_kernel():
    assert set(_build.SIGNATURES) == set(ops.KERNELS) | {
        "lsh_hash_resolve", "flash_attention_sm90", "bucket_insert_pass",
        "bucket_insert_pass_masked"}
    assert _build.ROUTE_OF == {
        "lsh_hash_resolve": ("lsh_hash",),
        "flash_attention_sm90": ("flash_attention",),
        "bucket_insert_pass": ("slot_counts", "bucket_core_stats"),
        "bucket_insert_pass_masked": ("slot_counts", "bucket_core_stats")}
    for dtype in (torch.float32, torch.bfloat16):
        assert fa.plan(dtype, 64).entry in _build.SIGNATURES
    assert set(ops.launch_counts()) == set(ops.KERNELS)
    assert set(ops.entry_launch_counts()) == set(_build.SIGNATURES)
    # the bf16 route's backward is a kernel of its own, not a route of
    # flash_attention, and the plain backward on the card is counted apart
    assert "attention_bwd_sm90" in ops.KERNELS
    assert "attention_bwd_sm90" not in _build.ROUTE_OF
    assert fa.bwd_plan(torch.bfloat16, 128) == "wgmma"
    assert fa.bwd_plan(torch.float32, 64) == "plain"
    assert ops.plain_on_card_counts() == {"attention_vjp": 0}
    # no backward kernel may carry the forward's name, which the
    # benchmark's flash_attention_roofline prices as one forward each
    src = (_build.CSRC / "flash_attention_sm90.cu").read_text()
    names = re.findall(r"^(\w+_kernel)\(", src, re.M)
    bwd = [n for n in names if "bwd" in n]
    assert "flash_attention_sm90_kernel" in names and len(bwd) == 3
    assert bwd and not any("flash_attention_sm90" in n for n in bwd)


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
