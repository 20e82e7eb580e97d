"""The port's structure-of-arrays engine against the JAX package's.

``repro_torch.core.soa.SoADynamicDBSCAN`` — on the device path with
``device="cpu"`` (the plain kernels) and on the host path (``soa``) —
is driven through the same batch-grained mixed insert/delete streams as
``repro.core.soa.SoADynamicDBSCAN(use_device="interpret")``, whose batch
passes run the Pallas kernels in interpret mode.  At every step the
label dicts, the compacted delta journals and every ``state_dict()``
array must be identical: tolerance zero, since all of them are integer
(the points are the inserted float64 values, stored unchanged).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.hashing import GridLSH as JaxGridLSH  # noqa: E402
from repro.core.soa import SoADynamicDBSCAN as JaxSoA  # noqa: E402
from repro.data import blobs  # noqa: E402
from repro_torch.core.hashing import GridLSH  # noqa: E402
from repro_torch.core.soa import SoADynamicDBSCAN  # noqa: E402
from repro_torch.data import blobs as torch_blobs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for key in sa:
        assert sa[key].dtype == sb[key].dtype, key
        np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)


@pytest.mark.parametrize("d,eps,t,seed", [(4, 0.45, 8, 0), (10, 0.75, 10, 3),
                                          (7, 0.2, 1, 11)])
def test_gridlsh_family_and_keys_bit_identical(d, eps, t, seed):
    ref, port = JaxGridLSH(d, eps, t, seed), GridLSH(d, eps, t, seed)
    np.testing.assert_array_equal(port.eta, ref.eta)
    np.testing.assert_array_equal(port.mixers, ref.mixers)
    assert port.eta.dtype == ref.eta.dtype
    assert port.mixers.dtype == ref.mixers.dtype
    assert port.inv_cell == ref.inv_cell
    X = np.random.default_rng(seed).normal(size=(97, d)) * 3
    for tables in (None, 1, t):
        np.testing.assert_array_equal(port.device_keys_batch(X, tables),
                                      ref.device_keys_batch(X, tables))
        np.testing.assert_array_equal(port.codes_batch(X, tables),
                                      ref.codes_batch(X, tables))


def test_blobs_identical():
    for a, b in zip(torch_blobs(n=500, d=10, seed=4),
                    blobs(n=500, d=10, seed=4)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("orphans", [True, False])
def test_soa_matches_reference_interpret(seed, orphans):
    """Batch-grained mixed stream with pinned out-of-order ids (the
    stream of tests/test_soa.py): the port's device path on the CPU and
    its host path agree with the reference's Pallas interpret path."""
    rng = np.random.default_rng(seed + 50)
    X, _ = blobs(n=400, d=4, n_clusters=4, cluster_std=0.3, seed=seed)
    args = (4, 8, 8, 0.45)
    kw = dict(seed=seed, attach_orphans=orphans)
    ref = JaxSoA(*args, use_device="interpret", **kw)
    dev = SoADynamicDBSCAN(*args, use_device=True, device="cpu", **kw)
    host = SoADynamicDBSCAN(*args, use_device=False, **kw)
    engines = (ref, dev, host)
    ops.reset_launch_counts()
    pos, alive = 0, []
    while pos < len(X):
        b = int(rng.integers(1, 50))
        chunk = X[pos:pos + b]
        pos += b
        ids = None
        if rng.random() < 0.3:
            base = 10_000 + pos * 10
            ids = [None if rng.random() < 0.5 else base + j
                   for j in range(len(chunk))]
        got = [e.add_batch(chunk, ids=ids) for e in engines]
        assert got[0] == got[1] == got[2]
        alive.extend(got[0])
        deltas = [sorted(e.drain_deltas()) for e in engines]
        assert deltas[0] == deltas[1] == deltas[2]
        if rng.random() < 0.5 and len(alive) > 30:
            nd = int(rng.integers(1, min(20, len(alive) - 10)))
            dels = [alive.pop(int(rng.integers(len(alive))))
                    for _ in range(nd)]
            for e in engines:
                e.delete_batch(dels)
            deltas = [sorted(e.drain_deltas()) for e in engines]
            assert deltas[0] == deltas[1] == deltas[2]
        labels = [e.labels() for e in engines]
        assert labels[0] == labels[1] == labels[2]
        _assert_same_state(ref, dev)
        _assert_same_state(ref, host)
    for e in engines:
        e.check_invariants()
    # the CPU device path ran the plain versions: no kernel launched
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_soa_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SoADynamicDBSCAN(4, 8, 8, 0.45, use_device=True)


def test_soa_rejects_unsupported_device():
    with pytest.raises(ValueError, match="unsupported device"):
        SoADynamicDBSCAN(4, 8, 8, 0.45, use_device=True, device="meta")
