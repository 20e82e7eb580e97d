"""The port's training path against the JAX package's, on the CPU.

The same parameters (drawn by ``repro``'s init, carried over by
``repro_torch.models.convert.params_from_jax``) and the same numpy
batches go through both packages:

- ``lm_loss`` and the gradient of every parameter against
  ``jax.value_and_grad`` of ``repro.models.transformer.lm_loss``.
  float32 compute: rtol 1e-4 / atol 1e-5 (measured: the loss equal, the
  gradients within 1.1e-6 of each leaf's largest).  bfloat16 compute:
  the loss within 1e-2 and each gradient within 5e-2 of its leaf's
  largest |gradient| (measured: 1.7e-3 and 1.7e-2; the frameworks round
  to bf16 at different places, see ``test_torch_models.py``).
- The flash-attention ``autograd.Function`` passes ``gradcheck`` in
  float64 (its forward is the plain version on the CPU).
- ``AdamW`` over 5 steps with the same gradients: parameters and both
  moments within rtol 1e-6 / atol 1e-7, the step equal, the schedule
  within rtol 5e-7 (XLA's ``cos`` differs from torch's by an ulp at
  some steps: the learning rate then differs by up to two ulps).
- ``make_train_step`` (accumulation 1 and 2) against the reference's
  jitted step without a mesh: loss, gradient norm and parameters within
  the float32 tolerance above over 3 steps.
- Gradient compression: int8 and top-k equal (tie-free data), and the
  loop of ``tests/test_compression_integration.py`` loss for loss.
- ``train()`` over 30 steps with ``--curation balance`` (bf16 compute)
  against a JAX loop that restates ``repro.launch.train.main`` without
  its mesh: loss for loss within 1e-2 (measured: 1.7e-3).
- The reference trainer's protocol on the port: 30 steps, then
  ``--resume`` for 2 more.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import CurationFilter as JaxCuration  # noqa: E402
from repro.data.pipeline import Pipeline as JaxPipeline  # noqa: E402
from repro.data.pipeline import SyntheticTokenStream as JaxStream  # noqa: E402
from repro.distributed import compression as jax_comp  # noqa: E402
from repro.models.registry import build_model as jax_build  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro.training import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import FlashAttention  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.optim import AdamW, warmup_cosine  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402

F32 = dict(rtol=1e-4, atol=1e-5)
BF16_LOSS_TOL = 1e-2
BF16_GRAD_TOL = 5e-2
TRAIN_LOSS_TOL = 1e-2


def _models(dtype, seed=0, **changes):
    jcfg = dataclasses.replace(jax_get_config("granite-20b").smoke(),
                               dtype=dtype, **changes)
    tcfg = dataclasses.replace(get_config("granite-20b").smoke(),
                               dtype=dtype, **changes)
    jm = jax_build(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(tcfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jm, jp, tcfg, tm, tp


def _batch(b=4, s=32, vocab=256, seed=0, ignore_last=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    if ignore_last:
        labels[:, -1] = -1
    return toks, labels.astype(np.int32)


def _jb(toks, labels):
    return {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}


def _tb(toks, labels):
    return {"tokens": torch.from_numpy(toks).long(),
            "labels": torch.from_numpy(labels).long()}


def _as_port(jtree, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jtree), cfg, "cpu")


# ---------------------------------------------------------------------- #
# loss and gradients
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_loss_and_grads_match_jax(dtype):
    jcfg, jm, jp, tcfg, tm, tp = _models(dtype)
    toks, labels = _batch()
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss(p, _jb(toks, labels)), has_aux=True)(jp)
    live = tree_map(lambda p: p.detach().requires_grad_(), tp)
    tl, tmet = tm.loss(live, _tb(toks, labels))
    tl.backward()
    tl = tl.detach()
    assert float(tmet["tokens"]) == float(jmet["tokens"]) == 4 * 31
    assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0
    want = tree_leaves(_as_port(jg, tcfg))
    got = [p.grad for p in tree_leaves(live)]
    assert len(want) == len(got)
    if dtype == "float32":
        np.testing.assert_allclose(float(tl), float(jl), **F32)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **F32)
    else:
        assert abs(float(tl) - float(jl)) < BF16_LOSS_TOL
        for w, g in zip(want, got):
            scale = float(w.abs().max())
            assert float((g - w).abs().max()) <= BF16_GRAD_TOL * scale


def test_lm_loss_masks_vocab_padding_and_ignored_labels():
    """A vocabulary that is not a multiple of 256 (padded logits masked
    to -1e30) and ignored labels (< 0), against the reference's loss."""
    jcfg, jm, jp, tcfg, tm, tp = _models("float32", vocab_size=200)
    assert tcfg.padded_vocab == 256
    toks, labels = _batch(vocab=200, seed=3)
    labels[0, :5] = -1
    jl, jmet = jm.loss(jp, _jb(toks, labels))
    tl, tmet = tm.loss(tp, _tb(toks, labels))
    np.testing.assert_allclose(float(tl), float(jl), **F32)
    assert float(tmet["tokens"]) == float(jmet["tokens"])


def test_remat_recomputes_the_same_gradients():
    """cfg.remat runs each layer under torch.utils.checkpoint when a
    gradient is taken: the gradients equal those without it, bit for
    bit; with no gradient the forward takes no checkpoint."""
    grads = {}
    for remat in (True, False):
        *_, tcfg, tm, tp = _models("float32", remat=remat)
        live = tree_map(lambda p: p.detach().requires_grad_(), tp)
        loss, _ = tm.loss(live, _tb(*_batch()))
        loss.backward()
        grads[remat] = [p.grad for p in tree_leaves(live)]
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------- #
# the flash kernel under autograd
# ---------------------------------------------------------------------- #
GRAD_CASES = [  # (b, hq, hkv, sq, dh, causal, window)
    (2, 4, 2, 6, 3, True, None),     # GQA, causal
    (1, 4, 1, 7, 4, True, 3),        # MQA, sliding window
    (2, 2, 2, 5, 3, False, None),    # no mask
    (1, 6, 2, 9, 2, True, 4),        # GQA, causal and window
]


@pytest.mark.parametrize("case", GRAD_CASES, ids=str)
def test_flash_function_gradcheck_f64(case):
    b, hq, hkv, s, dh, causal, window = case
    g = torch.Generator().manual_seed(s * 10 + dh)
    q, k, v = (torch.randn(shape, generator=g, dtype=torch.float64,
                           requires_grad=True)
               for shape in ((b, hq, s, dh), (b, hkv, s, dh),
                             (b, hkv, s, dh)))
    assert torch.autograd.gradcheck(
        lambda a, b_, c: ops.attention(a, b_, c, causal=causal,
                                       window=window), (q, k, v))


def test_attention_takes_the_function_only_under_grad():
    q = torch.randn(1, 4, 8, 16)
    k = torch.randn(1, 2, 8, 16)
    plain = ops.attention(q, k, k)
    assert plain.grad_fn is None
    qg = q.clone().requires_grad_()
    out = ops.attention(qg, k, k)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(out.detach(), plain)
    with torch.no_grad():
        assert ops.attention(qg, k, k).grad_fn is None
    out.sum().backward()
    q2 = q.clone().requires_grad_()
    from repro_torch.kernels import ref
    ref.attention(q2, k, k).sum().backward()
    assert torch.equal(qg.grad, q2.grad)


def test_function_backward_chunks_batch_rows(monkeypatch):
    """The backward recomputes the plain version a chunk of batch rows
    at a time; the chunks give the gradient of the whole."""
    import repro_torch.kernels.flash_attention as fa

    g = torch.Generator().manual_seed(5)
    q = torch.randn(5, 4, 12, 8, generator=g, requires_grad=True)
    k = torch.randn(5, 2, 12, 8, generator=g, requires_grad=True)
    v = torch.randn(5, 2, 12, 8, generator=g, requires_grad=True)
    dout = torch.randn(5, 4, 12, 8, generator=g)
    whole = torch.autograd.grad(
        FlashAttention.apply(q, k, v, True, 5, 0, None, False),
        (q, k, v), dout)
    monkeypatch.setattr(fa, "_BWD_SCORE_BYTES", 4 * 12 * 12 * 4 * 2)
    chunked = torch.autograd.grad(
        FlashAttention.apply(q, k, v, True, 5, 0, None, False),
        (q, k, v), dout)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------- #
# optimizer
# ---------------------------------------------------------------------- #
def test_warmup_cosine_matches_reference():
    for args in ((1e-2, 20, 100), (3e-4, 5, 30, 0.2), (1.0, 0, 10)):
        mine, ref = warmup_cosine(*args), jax_warmup_cosine(*args)
        for step in range(0, 130):
            np.testing.assert_allclose(mine(step), float(ref(step)),
                                       rtol=5e-7, atol=0)


def _opt_tree(rng):
    return {"layers": {"w": rng.normal(size=(4, 8)).astype(np.float32)},
            "head": rng.normal(size=(8,)).astype(np.float32),
            "bias": rng.normal(size=(3, 2, 5)).astype(np.float32)}


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_matches_reference_over_five_steps(clip):
    rng = np.random.default_rng(7)
    p0 = _opt_tree(rng)
    grads = [tree_map(lambda a: (rng.normal(size=a.shape) * 3).astype(
        np.float32), p0) for _ in range(5)]
    jopt = JaxAdamW(lr=jax_warmup_cosine(1e-2, 2, 10), clip_norm=clip)
    topt = AdamW(lr=warmup_cosine(1e-2, 2, 10), clip_norm=clip)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jopt.init(jp)
    tp = tree_map(torch.from_numpy, tree_map(np.copy, p0))
    ts = topt.init(tp)
    for g in grads:
        jp, js, jmet = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tmet = topt.update(tree_map(torch.from_numpy, g), ts, tp)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tmet["lr"], float(jmet["lr"]),
                                   rtol=5e-7)
    assert int(ts["step"]) == int(js["step"]) == 5
    for mine, ref in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for a, b in zip(tree_leaves(mine), jax.tree.leaves(ref)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-6, atol=1e-7)


def test_adamw_updates_in_place():
    p = {"w": torch.ones(3)}
    opt = AdamW(lr=lambda s: 0.1)
    st = opt.init(p)
    w = p["w"]
    p2, st2, _ = opt.update({"w": torch.ones(3)}, st, p)
    assert p2["w"] is w and st2["m"]["w"] is st["m"]["w"]
    assert float(w[0]) < 1.0 and int(st2["step"]) == 1
    assert st2["step"].device.type == "cpu"


# ---------------------------------------------------------------------- #
# the train step
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    jcfg, jm, jp, tcfg, tm, tp = _models("float32")
    jopt = JaxAdamW(lr=jax_warmup_cosine(5e-3, 2, 100))
    topt = AdamW(lr=warmup_cosine(5e-3, 2, 100))
    jstep = jax.jit(jax_make_train_step(jm, jopt, mesh=None,
                                        grad_accum=accum))
    tstep = make_train_step(tm, topt, grad_accum=accum)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        toks, labels = _batch(seed=10 + i)
        jp, js, jmet = jstep(jp, js, _jb(toks, labels))
        tp, ts, tmet = tstep(tp, ts, _tb(toks, labels))
        assert set(tmet) == set(jmet)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       **F32)
    for a, b in zip(tree_leaves(tp), tree_leaves(_as_port(jp, tcfg))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F32)


# ---------------------------------------------------------------------- #
# gradient compression
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [1, 1000, 4096, 9000])
def test_int8_compression_matches_reference(n):
    g = np.random.default_rng(n).normal(size=(n,)).astype(np.float32) * 3
    jd, jr = jax_comp.int8_compress_decompress(jnp.asarray(g))
    td, tr = comp.int8_compress_decompress(torch.from_numpy(g))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("frac", [0.05, 0.4])
def test_topk_compression_matches_reference(frac):
    # a permutation of distinct magnitudes: no tie at the k-th place
    rng = np.random.default_rng(3)
    g = (rng.permutation(500) + 1).astype(np.float32) * \
        rng.choice([-1.0, 1.0], 500).astype(np.float32) / 7
    jk, jr = jax_comp.topk_compress_decompress(jnp.asarray(g), frac)
    tk, tr = comp.topk_compress_decompress(torch.from_numpy(g), frac)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_error_feedback_matches_reference():
    jinit, jt = jax_comp.make_compressed_grad_transform("int8")
    tinit, tt = comp.make_compressed_grad_transform("int8")
    rng = np.random.default_rng(1)

    def tree():
        return {"w": rng.normal(size=(64,)).astype(np.float32),
                "layers": [{"a": rng.normal(size=(3, 5)).astype(np.float32)}
                           for _ in range(2)]}

    zeros = tree_map(np.zeros_like, tree())
    jres = jinit(jax.tree.map(jnp.asarray, zeros))
    tres = tinit(tree_map(torch.from_numpy, zeros))
    for _ in range(20):
        g = tree()
        jout, jres = jt(jax.tree.map(jnp.asarray, g), jres)
        tout, tres = tt(tree_map(torch.from_numpy, g), tres)
        for a, b in zip(tree_leaves(tout) + tree_leaves(tres),
                        jax.tree.leaves(jout) + jax.tree.leaves(jres)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _compression_run(pkg, steps, compressed):
    """``tests/test_compression_integration.py``'s loop in ``pkg``."""
    jcfg, jm, jp, tcfg, tm, tp = _models("float32")
    toks = np.random.default_rng(0).integers(0, 256, (steps, 4, 32))
    if pkg == "jax":
        opt, params, make = (JaxAdamW(lr=jax_warmup_cosine(5e-3, 2, 100)),
                             jp, jax_make_train_step)
        model, tf, batch = jm, jax_comp, lambda t: _jb(t, t)
    else:
        opt, params, make = (AdamW(lr=warmup_cosine(5e-3, 2, 100)), tp,
                             make_train_step)
        model, tf, batch = tm, comp, lambda t: _tb(t, t)
    state = opt.init(params)
    hook = None
    if compressed:
        init_res, transform = tf.make_compressed_grad_transform("int8")
        holder = {"res": init_res(params)}

        def hook(grads):
            out, holder["res"] = transform(grads, holder["res"])
            return out
    step = make(model, opt, grad_accum=1, grad_transform=hook)
    losses = []
    for i in range(steps):
        params, state, m = step(params, state, batch(toks[i]))
        losses.append(float(m["loss"]))
    return losses


@pytest.mark.parametrize("compressed", [False, True])
def test_compression_integration_loop_matches_reference(compressed):
    ref = _compression_run("jax", 10, compressed)
    mine = _compression_run("torch", 10, compressed)
    np.testing.assert_allclose(mine, ref, rtol=1e-4, atol=1e-4)
    assert mine[-1] < mine[0]


# ---------------------------------------------------------------------- #
# the trainer
# ---------------------------------------------------------------------- #
def _train_args(tmp_path, *extra):
    return ["--arch", "granite-20b", "--smoke", "--batch", "4", "--seq",
            "32", "--lr", "1e-2", "--device", "cpu", "--ckpt-dir",
            str(tmp_path), *extra]


def test_train_matches_jax_loop(tmp_path):
    """30 steps with ``--curation balance`` against the reference's
    ``main`` restated without its mesh, from the same parameters."""
    args = train_mod.parse_args(_train_args(
        tmp_path, "--steps", "30", "--curation", "balance",
        "--ckpt-every", "1000"))
    cfg = train_mod.config_of(args)
    jcfg = jax_get_config("granite-20b").smoke()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jm = jax_build(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tp = _as_port(jp, cfg)
    opt = JaxAdamW(lr=jax_warmup_cosine(1e-2, 20, 100))
    js = opt.init(jp)
    step = jax.jit(jax_make_train_step(jm, opt, mesh=None, grad_accum=1))
    src = JaxStream(cfg.vocab_size, 32, 4, seed=1)
    pipe = JaxPipeline(iter(src), curation=JaxCuration(
        d=src.embed_dim, k=8, t=8, eps=0.6, policy="balance",
        window=20_000))
    want = []
    for _ in range(30):
        b = next(pipe)
        jp, js, m = step(jp, js, _jb(b["tokens"], b["labels"]))
        want.append(float(m["loss"]))
    pipe.close()
    got = [m["loss"] for m in train_mod.train(cfg, args, params=tp)]
    assert len(got) == 30
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAIN_LOSS_TOL)


def test_train_loop_converges_and_restarts(tmp_path):
    """The reference trainer's protocol (``tests/test_system.py``) on the
    port: loss falls over 30 steps; ``--resume`` continues at step 30."""
    losses = train_mod.main(_train_args(tmp_path, "--steps", "30",
                                        "--ckpt-every", "10"))
    assert np.mean(losses[-5:]) < np.mean(losses[:3]), losses
    ckpt = tmp_path / "granite-20b"
    assert sorted(p.name for p in ckpt.glob("step_*")) == [
        "step_00000020", "step_00000030"]
    args = train_mod.parse_args(_train_args(
        tmp_path, "--steps", "32", "--ckpt-every", "10", "--resume"))
    resumed = train_mod.train(train_mod.config_of(args), args)
    assert [m["step"] for m in resumed] == [30, 31]


def test_train_returns_each_steps_metrics(tmp_path):
    """``train`` returns every step's loss, gradient norm and seconds;
    ``main`` the losses alone, as the reference's does."""
    args = train_mod.parse_args(_train_args(
        tmp_path, "--steps", "3", "--ckpt-every", "1000", "--grad-accum",
        "2"))
    steps = train_mod.train(train_mod.config_of(args), args)
    assert [m["step"] for m in steps] == [0, 1, 2]
    for m in steps:
        assert sorted(m) == ["grad_norm", "loss", "seconds", "step"]
        assert np.isfinite(m["loss"]) and m["grad_norm"] > 0
        assert m["seconds"] > 0
    losses = train_mod.main(_train_args(
        tmp_path / "again", "--steps", "3", "--ckpt-every", "1000",
        "--grad-accum", "2"))
    np.testing.assert_allclose(losses, [m["loss"] for m in steps],
                               rtol=1e-6)


def test_train_entry_points_default_to_the_card():
    args = train_mod.parse_args([])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            train_mod.main(["--smoke", "--steps", "1"])
