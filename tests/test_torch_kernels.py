"""The port's kernels against the JAX package's.

On the CPU the port's wrappers run the plain PyTorch versions
(``repro_torch.kernels.ref``); they are held bit-exact against
``repro.kernels.ref`` on in-range ids and against the Pallas kernels in
interpret mode on every id, out-of-range ones included.  Tolerance: zero
— every result is an integer (or an int32 hash) and must be identical.

Out-of-range ids: the Pallas kernels drop an id >= n, and drop a
negative id because it wraps into the zero padding that rounds n up to a
multiple of 128 — so a negative id in ``[-pad, -1]`` (pad = -n % 128) is
dropped, while ``repro.kernels.ref`` wraps it onto a real slot.  The
port drops every id outside ``[0, n)``; the sweeps below draw ids from
``[-pad, n + 9)``, the range on which the TPU kernels drop.

``eps_neighbor_counts``: tolerance zero as well.  The port's plain
version sums in a fixed f32 order (k = 0..d-1, every product and sum a
separate op), and its counts equal ``repro.kernels.ref`` and the Pallas
kernel in interpret mode on the sweeps of ``tests/test_kernels.py`` and
on the paper's blobs at 4,000 points.

The CUDA kernels are held against these plain versions on the card in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.kernels.lsh_hash as jax_lh  # noqa: E402
import repro.kernels.pairwise_dist as jax_pd  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.data import blobs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

LSH_SHAPES = [(64, 4, 3), (200, 16, 10), (33, 7, 5), (256, 20, 8)]
BUCKET_SHAPES = [(1, 1, 1), (7, 3, 5), (203, 7, 37), (256, 8, 128),
                 (301, 10, 513)]


def _lsh_inputs(n, d, t, scale=1.0):
    rng = np.random.default_rng(n + d + t)
    x = (rng.normal(size=(n, d)) * scale).astype(np.float32)
    eta = rng.uniform(0, 1.5, size=(t,)).astype(np.float32)
    mixers = rng.integers(1, 2**31 - 1, size=(2, t, d)).astype(np.int32) | 1
    return x, eta, mixers


def _slots(n, t, nb, seed, out_of_range):
    rng = np.random.default_rng(seed)
    lo = -(-nb % 128) if out_of_range else 0
    hi = nb + 9 if out_of_range else nb
    return rng.integers(lo, hi, (n, t)).astype(np.int32)


# --------------------------------------------------------------------- #
# lsh_hash
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("scale", [1.0, 300.0])
@pytest.mark.parametrize("n,d,t", LSH_SHAPES)
def test_lsh_hash_matches_jax(n, d, t, scale):
    """Bit-exact against the jnp oracle and the Pallas kernel; the large
    scale drives the int32 products and sums through wrap-around."""
    x, eta, mixers = _lsh_inputs(n, d, t, scale)
    got = ops.lsh_hash(torch.from_numpy(x), torch.from_numpy(eta),
                       torch.from_numpy(mixers), inv_cell=1 / 1.5).numpy()
    want_ref = np.asarray(jax_ref.lsh_hash(
        jnp.asarray(x), jnp.asarray(eta), jnp.asarray(mixers), 1 / 1.5))
    want_pallas = np.asarray(jax_lh.lsh_hash(
        x, eta, mixers, inv_cell=1 / 1.5, block_n=64, interpret=True))
    assert got.dtype == np.int32 and got.shape == (n, t, 2)
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_array_equal(got, want_pallas)


# --------------------------------------------------------------------- #
# slot_counts / bucket_core_stats
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n,t,nb", BUCKET_SHAPES)
def test_slot_counts_matches_jax(n, t, nb):
    inr = _slots(n, t, nb, n * 17 + nb, out_of_range=False)
    got = ops.slot_counts(torch.from_numpy(inr), n_slots=nb).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jax_ref.slot_counts(jnp.asarray(inr), nb)))
    anyid = _slots(n, t, nb, n * 19 + nb, out_of_range=True)
    got = ops.slot_counts(torch.from_numpy(anyid), n_slots=nb).numpy()
    want = np.asarray(jax_ops.slot_counts(
        jnp.asarray(anyid), n_slots=nb, impl="pallas_interpret"))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,t,nb", BUCKET_SHAPES)
def test_bucket_core_stats_matches_jax(n, t, nb):
    rng = np.random.default_rng(n * 31 + t)
    sizes = rng.integers(0, 12, nb).astype(np.int32)
    inr = _slots(n, t, nb, n * 37 + t, out_of_range=False)
    anyid = _slots(n, t, nb, n * 41 + t, out_of_range=True)
    for k in (1, 3, 9):
        sp, cp = ops.bucket_core_stats(torch.from_numpy(inr),
                                       torch.from_numpy(sizes), k=k)
        sr, cr = jax_ref.bucket_core_stats(jnp.asarray(inr),
                                           jnp.asarray(sizes), k)
        np.testing.assert_array_equal(sp.numpy(), np.asarray(sr))
        np.testing.assert_array_equal(cp.numpy(), np.asarray(cr))
        sp, cp = ops.bucket_core_stats(torch.from_numpy(anyid),
                                       torch.from_numpy(sizes), k=k)
        sk, ck = jax_ops.bucket_core_stats(
            jnp.asarray(anyid), jnp.asarray(sizes), k=k,
            impl="pallas_interpret")
        assert sp.dtype == cp.dtype == torch.int32
        np.testing.assert_array_equal(sp.numpy(), np.asarray(sk))
        np.testing.assert_array_equal(cp.numpy(), np.asarray(ck))


def test_out_of_range_ids_follow_the_tpu_kernel():
    """Slot ids [[0,1],[-1,5],[7,2]]: ``repro.kernels.ref`` wraps -1 to
    the last slot; the Pallas kernels and the port drop it."""
    s = np.array([[0, 1], [-1, 5], [7, 2]], np.int32)
    counts = ops.slot_counts(torch.from_numpy(s), n_slots=5).numpy()
    np.testing.assert_array_equal(counts, [1, 1, 1, 0, 0])
    np.testing.assert_array_equal(counts, np.asarray(jax_ops.slot_counts(
        jnp.asarray(s), n_slots=5, impl="pallas_interpret")))
    sizes = np.full(3, 3, np.int32)
    supp, core = ops.bucket_core_stats(torch.from_numpy(s),
                                       torch.from_numpy(sizes), k=2)
    np.testing.assert_array_equal(supp.numpy(), [2, 0, 1])
    np.testing.assert_array_equal(core.numpy(), [1, 0, 1])
    sk, _ = jax_ops.bucket_core_stats(jnp.asarray(s), jnp.asarray(sizes),
                                      k=2, impl="pallas_interpret")
    np.testing.assert_array_equal(supp.numpy(), np.asarray(sk))


# --------------------------------------------------------------------- #
# eps_neighbor_counts
# --------------------------------------------------------------------- #
def _eps_inputs(n, d):
    rng = np.random.default_rng(n * d)
    return (rng.normal(size=(n, d)) * 0.7).astype(np.float32)


def _assert_eps_counts_match_jax(x, eps):
    got = ops.eps_neighbor_counts(torch.from_numpy(x), eps=eps).numpy()
    want_ref = np.asarray(jax_ref.eps_neighbor_counts(jnp.asarray(x), eps))
    want_pallas = np.asarray(jax_pd.eps_neighbor_counts(
        x, eps=eps, block_m=64, block_n=64, interpret=True))
    assert got.dtype == np.int32 and got.shape == (x.shape[0],)
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_array_equal(got, want_pallas)


@pytest.mark.parametrize("n,d", [(50, 3), (130, 8), (257, 16)])
def test_eps_neighbor_counts_matches_jax(n, d):
    _assert_eps_counts_match_jax(_eps_inputs(n, d), 0.8)


def test_eps_neighbor_counts_matches_jax_on_blobs():
    """The paper's blobs at 4,000 points and eps 0.75: ~374 neighbours a
    point, so many pairs lie near the boundary."""
    X, _ = blobs(n=4000, d=10, seed=0)
    _assert_eps_counts_match_jax(X.astype(np.float32), 0.75)


@pytest.mark.parametrize("eps", [0.3, 1.0, 2.5])
def test_eps_neighbor_counts_match_exact_numpy(eps):
    """Against the (x_i - x_j)^2 form of ``tests/test_kernels.py``."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(80, 5)).astype(np.float32)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    exact = (d2 <= eps * eps + 1e-6).sum(-1)
    got = ops.eps_neighbor_counts(torch.from_numpy(x), eps=eps).numpy()
    np.testing.assert_array_equal(got, exact)


def test_eps_neighbor_counts_row_blocks_do_not_change_counts(monkeypatch):
    x = torch.from_numpy(_eps_inputs(301, 7))
    whole = ref.eps_neighbor_counts(x, 0.9)
    # 4 * 301 * 13 bytes: row blocks of 13, the last one ragged
    monkeypatch.setattr(ref, "_EPS_BLOCK_BYTES", 4 * 301 * 13)
    assert torch.equal(ref.eps_neighbor_counts(x, 0.9), whole)
    assert ref.eps_threshold(0.75) == float(np.float32(0.75 * 0.75 + 1e-6))
    empty = ref.eps_neighbor_counts(torch.zeros((0, 4)), 0.5)
    assert empty.shape == (0,) and empty.dtype == torch.int32


def test_cpu_dispatch_runs_plain_versions_and_counts_no_launch():
    ops.reset_launch_counts()
    x, eta, mixers = _lsh_inputs(16, 4, 3)
    s = _slots(16, 3, 11, 0, out_of_range=False)
    a = ops.lsh_hash(torch.from_numpy(x), torch.from_numpy(eta),
                     torch.from_numpy(mixers), inv_cell=0.5)
    b = ops.lsh_hash(torch.from_numpy(x), torch.from_numpy(eta),
                     torch.from_numpy(mixers), inv_cell=0.5, impl="ref")
    assert torch.equal(a, b)
    assert torch.equal(
        ops.slot_counts(torch.from_numpy(s), n_slots=11),
        ref.slot_counts(torch.from_numpy(s), 11))
    x = torch.from_numpy(_eps_inputs(40, 3))
    assert torch.equal(ops.eps_neighbor_counts(x, eps=0.8),
                       ops.eps_neighbor_counts(x, eps=0.8, impl="ref"))
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    with pytest.raises(ValueError):
        ops.slot_counts(torch.from_numpy(s), n_slots=11, impl="pallas")


def test_cuda_wrappers_reject_cpu_tensors():
    """The CUDA wrappers never run the plain version themselves."""
    from repro_torch.kernels import bucket_ops, lsh_hash, pairwise_dist

    s = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bucket_ops.slot_counts(s, n_slots=3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bucket_ops.bucket_core_stats(s, torch.zeros(3, dtype=torch.int32),
                                     k=1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lsh_hash.lsh_hash(torch.zeros((4, 2)), torch.zeros(3),
                          torch.ones((2, 3, 2), dtype=torch.int32),
                          inv_cell=1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pairwise_dist.eps_neighbor_counts(torch.zeros((4, 2)), eps=1.0)
