"""The bf16 attention backward's algorithm on the CPU.

``attention_bwd_sm90`` recomputes P from the log-sum-exp that the bf16
forward stores, as the flash backward does; its plain PyTorch version is
``ref.attention_lse`` and ``ref.attention_bwd``.  Here, in f64, that
version is held against autograd through ``ref.attention`` (atol = rtol
= 1e-10: the same function in another order of f64 sums) over GQA, MQA,
causal and not, windows, ``q_offset`` and sq != skv; a row whose keys
are all masked (0 in the kernel's forward) gets gradient 0; zero-padded
head_dim columns add nothing, so the wrapper's padding changes no
gradient.  The kernel itself is held against the f32 gradient on the card
in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

F64_TOL = 1e-10

# b, hq, hkv, sq, skv, dh, causal, window, q_offset
CASES = [
    (2, 4, 2, 33, 33, 16, True, None, 0),      # GQA, causal
    (1, 6, 1, 20, 20, 8, True, None, 0),       # MQA
    (1, 4, 1, 17, 23, 8, False, None, 0),      # sq != skv, not causal
    (1, 3, 3, 20, 50, 8, True, 7, 30),         # window, q_offset
    (2, 4, 2, 1, 40, 12, True, None, 39),      # one decode row
    (1, 4, 1, 17, 23, 8, False, 5, 3),         # window without causal
    (1, 2, 1, 70, 70, 16, True, 16, 0),        # window inside the row
]


def _inputs(case, dtype=torch.float64, seed=0):
    b, hq, hkv, sq, skv, dh = case[:6]
    rng = np.random.default_rng(seed + sq * 31 + skv)
    return [torch.from_numpy(rng.normal(size=s)).to(dtype)
            for s in ((b, hq, sq, dh), (b, hkv, skv, dh), (b, hkv, skv, dh),
                      (b, hq, sq, dh))]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_flash_backward_equals_autograd_in_f64(case):
    *_, causal, window, q_off = case
    kw = {"causal": causal, "window": window, "q_offset": q_off}
    q, k, v, dout = _inputs(case)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ref.attention(*leaves, **kw)
    want = torch.autograd.grad(out, leaves, dout)
    lse = ref.attention_lse(q, k, **kw)
    assert lse.dtype == torch.float64 and bool(torch.isfinite(lse).all())
    got = ref.attention_bwd(q, k, v, out.detach(), lse, dout, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        torch.testing.assert_close(g, w, atol=F64_TOL, rtol=F64_TOL)


@pytest.mark.parametrize("case", CASES[:4], ids=str)
def test_lse_is_the_log_of_the_softmax_normaliser(case):
    """exp(s - lse) is the forward's softmax: P V gives its output."""
    *_, causal, window, q_off = case
    kw = {"causal": causal, "window": window, "q_offset": q_off}
    q, k, v, _ = _inputs(case)
    lse = ref.attention_lse(q, k, **kw)
    s, mask = ref._kernel_scores(q, k, causal, window, q_off, None)
    p = torch.exp(s - lse[..., None])
    torch.testing.assert_close(p.sum(-1), torch.ones_like(lse), atol=1e-12,
                               rtol=1e-12)
    vv = v.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    torch.testing.assert_close(p @ vv, ref.attention(q, k, v, **kw),
                               atol=F64_TOL, rtol=F64_TOL)


def test_fully_masked_rows_get_zero_gradient():
    """q_offset -3 with a causal mask: rows 0-2 see no key.  Their lse is
    +inf, their dq is 0 and they add nothing to dk or dv, the gradient of
    the 0 the kernel's forward writes there."""
    case = (1, 2, 1, 8, 8, 8, True, None, -3)
    q, k, v, dout = _inputs(case)
    kw = {"causal": True, "window": None, "q_offset": -3}
    lse = ref.attention_lse(q, k, **kw)
    assert bool(torch.isinf(lse[..., :3]).all()) and bool((lse[..., :3] > 0)
                                                          .all())
    assert bool(torch.isfinite(lse[..., 3:]).all())
    out = ref.attention(q, k, v, **kw)
    out[..., :3, :] = 0.0
    dq, dk, dv = ref.attention_bwd(q, k, v, out, lse, dout, **kw)
    assert not dq[..., :3, :].any()
    live = [t[..., 3:, :].clone().requires_grad_() for t in (q, )]
    rest = ref.attention(live[0], k, v, causal=True, q_offset=0)
    want = torch.autograd.grad(rest, [live[0]], dout[..., 3:, :])[0]
    torch.testing.assert_close(dq[..., 3:, :], want, atol=F64_TOL,
                               rtol=F64_TOL)
    _, dk0, dv0 = ref.attention_bwd(q[..., 3:, :], k, v, out[..., 3:, :],
                                    lse[..., 3:], dout[..., 3:, :],
                                    causal=True, q_offset=0)
    torch.testing.assert_close(dk, dk0, atol=F64_TOL, rtol=F64_TOL)
    torch.testing.assert_close(dv, dv0, atol=F64_TOL, rtol=F64_TOL)


def test_padded_head_dim_changes_no_gradient():
    """The wrapper pads q, k, v and dO with zero columns (dh 36 -> 40)
    and keeps the true scale: the padded gradients are the unpadded ones
    and zeros."""
    case = (1, 4, 2, 30, 30, 36, True, 8, 0)
    q, k, v, dout = _inputs(case)
    kw = {"causal": True, "window": 8, "q_offset": 0}
    out = ref.attention(q, k, v, **kw)
    lse = ref.attention_lse(q, k, **kw)
    want = ref.attention_bwd(q, k, v, out, lse, dout, **kw)
    pad = [fa.pad_head_dim(t, 40) for t in (q, k, v, out, dout)]
    got = ref.attention_bwd(*pad[:4], lse, pad[4], scale=36 ** -0.5, **kw)
    for g, w in zip(got, want):
        assert not g[..., 36:].any()
        torch.testing.assert_close(g[..., :36], w, atol=F64_TOL,
                                   rtol=F64_TOL)


def test_bf16_rounding_of_p_and_ds_stays_near_the_f32_gradient():
    """In bf16 the algorithm rounds P and dS for their products, as the
    kernel does; against the f32 gradient of the same bf16 inputs it
    stays within 2% of each gradient's largest entry, like the plain
    bf16 autograd path (which also rounds the logits)."""
    case = (1, 4, 1, 64, 64, 32, True, None, 0)
    q, k, v, dout = (t.to(torch.bfloat16) for t in _inputs(case))
    kw = {"causal": True, "window": None, "q_offset": 0}
    f32 = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention(*f32, **kw), f32, dout.float())
    out = ref.attention(q.float(), k.float(), v.float(), **kw).to(
        torch.bfloat16)
    got = ref.attention_bwd(q, k, v, out, ref.attention_lse(q, k, **kw),
                            dout, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert float((g.float() - w).abs().max()) <= 0.02 * float(
            w.abs().max())


def test_cpu_backward_stays_plain_and_uncounted():
    """On the CPU ``FlashAttention`` keeps ``attention_vjp``: no launch, no
    count of a plain backward on the card."""
    q, k, v, dout = (t.to(torch.bfloat16) for t in _inputs(CASES[0]))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launch_counts()
    out = ops.attention(*leaves)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, dout)
    assert not any(ops.launch_counts().values())
    assert ops.plain_on_card_counts() == {"attention_vjp": 0}
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention(*plain), plain, dout)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_card_routes_refuse_cpu_tensors():
    q, k, v, dout = (t.to(torch.bfloat16) for t in _inputs(CASES[0]))
    lse = torch.zeros((2, 4, fa.lse_rows(33)))
    with pytest.raises(ValueError, match="CUDA"):
        fa.attention_bwd(q, k, v, q, lse, dout, causal=True, window=None,
                         q_offset=0, scale=None)
    with pytest.raises(ValueError, match="no backward kernel"):
        fa.attention_bwd(q.float(), k.float(), v.float(), q.float(), lse,
                         dout.float(), causal=True, window=None, q_offset=0,
                         scale=None)
    assert _build.PLAIN_ON_CARD == {"attention_vjp": 0}
