"""The port's MoE block (``repro_torch.models.moe``) against the JAX
package's dense-dispatch oracle (``repro.models.moe``), on the CPU.

The block's parameters are drawn by ``repro``'s ``init_moe`` and carried
over as numpy arrays; inputs come from a numpy seed, so the f32 router
logits do not tie (``jax.lax.top_k`` and ``torch.topk`` may break ties
differently).

Tolerances: float32 output and aux at atol = rtol = 1e-5, the
reference's own EP-against-dense tolerance (``tests/test_moe.py``;
measured: 2.4e-7); bfloat16 output at atol = rtol = 0.05 on outputs of
magnitude ~0.4, for the places where the frameworks may round the expert
products differently (measured: equal on the CPU; the routing is f32 in
both, so the same experts are chosen).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 0.05
ARCHS = ["dbrx-132b", "granite-moe-1b-a400m"]


def _block(arch, seed, dtype="float32"):
    jcfg = dataclasses.replace(jax_get_config(arch).smoke(), dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch).smoke(), dtype=dtype)
    jp, _ = JM.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def _x(cfg, seed, b=2, s=16):
    return (np.random.default_rng(seed).normal(size=(b, s, cfg.d_model))
            * 0.5).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed", [0, 1])
def test_moe_block_dense_matches_jax_f32(arch, seed):
    jcfg, tcfg, jp, tp = _block(arch, seed)
    x = _x(tcfg, seed)
    jy, jaux = JM.moe_block_dense(jp, jnp.asarray(x), jcfg, jnp.float32)
    ty, taux = M.moe_block_dense(tp, torch.from_numpy(x), tcfg, torch.float32)
    assert ty.shape == x.shape and taux.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=F32_TOL,
                               rtol=F32_TOL)
    assert float(taux) > 0.0


def test_moe_block_dense_matches_jax_bf16():
    jcfg, tcfg, jp, tp = _block("granite-moe-1b-a400m", 2, "bfloat16")
    x = _x(tcfg, 2)
    jy, jaux = JM.moe_block_dense(jp, jnp.asarray(x, jnp.bfloat16), jcfg,
                                  jnp.bfloat16)
    ty, taux = M.moe_block_dense(tp, torch.from_numpy(x).bfloat16(), tcfg,
                                 torch.bfloat16)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32), atol=BF16_TOL,
                               rtol=BF16_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=F32_TOL,
                               rtol=F32_TOL)


def test_dense_dispatch_equals_top_k_dispatch():
    """Only each token's top-k experts contribute: the dense block equals
    running each token through its k experts alone, weighted by the
    renormalised top-k probabilities."""
    _, cfg, _, p = _block("granite-moe-1b-a400m", 3)
    x = torch.from_numpy(_x(cfg, 3)).reshape(-1, cfg.d_model)
    y, _ = M.moe_block_dense(p, x[None], cfg, torch.float32)
    probs = torch.softmax(x @ p["router"], dim=-1)
    vals, idx = torch.topk(probs, cfg.top_k, dim=-1)
    vals = vals / (vals.sum(-1, keepdim=True) + 1e-9)
    want = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for j in range(cfg.top_k):
            e = int(idx[t, j])
            h = M._expert_ffn(p["w_gate"][e:e + 1], p["w_up"][e:e + 1],
                              p["w_down"][e:e + 1], x[None, t:t + 1],
                              torch.float32)
            want[t] += vals[t, j] * h[0, 0]
    np.testing.assert_allclose(y[0].numpy(), want.numpy(), atol=F32_TOL,
                               rtol=F32_TOL)


def test_aux_loss_matches_jax_and_is_least_for_uniform_routing():
    X, k, T = 4, 2, 64
    rng = np.random.default_rng(4)
    probs = rng.dirichlet(np.ones(X), size=T).astype(np.float32)
    idx = np.argsort(-probs, axis=-1)[:, :k].astype(np.int32)
    np.testing.assert_allclose(
        float(M._aux_loss(torch.from_numpy(probs), torch.from_numpy(idx),
                          X)),
        float(JM._aux_loss(jnp.asarray(probs), jnp.asarray(idx), X)),
        rtol=F32_TOL)
    uniform = M._aux_loss(torch.full((T, X), 1.0 / X),
                          torch.arange(k).repeat(T, 1), X)
    skewed = M._aux_loss(torch.zeros(T, X).index_fill_(1,
                                                       torch.tensor([0]), 1),
                         torch.zeros(T, k, dtype=torch.long), X)
    assert float(skewed) > float(uniform)
    assert float(uniform) == pytest.approx(k, rel=0.01)
