"""The port's ``CheckpointManager`` against the JAX package's, on the CPU.

Mirrors ``tests/test_runtime.py``'s checkpoint tests (round trip, async
writes and garbage collection, crash safety) and
``tests/test_checkpoint_recovery.py`` (a crashed ``save_index`` keeps the
previous snapshot, on ``soa``, ``soa-device`` with ``device="cpu"``,
``batched`` and ``sharded``), then holds the two packages' directories
against each other:

- index checkpoints interchange both ways: a directory the port writes
  restores in ``repro`` with equal ``labels()``, and the reverse;
- the same parameter tree saved by both writes the same keys, shapes,
  dtypes and arrays;
- a ``step_*`` directory that ``repro``'s manager wrote for the smoke
  granite model loads in the port; split into layers by
  ``models/convert.py`` it gives the JAX loss (float32: rtol 1e-4 /
  atol 1e-5, the tolerance of ``test_torch_train.py``).
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import ClusterConfig as JaxConfig  # noqa: E402
from repro.api import build_index as jax_build_index  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JaxManager  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.registry import build_model as jax_build  # noqa: E402
from repro_torch.api import ClusterConfig, build_index  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import _flatten_with_paths  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import blobs  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "layers": {"w": torch.from_numpy(
            rng.normal(size=(4, 8)).astype(np.float32))},
        "head": torch.from_numpy(rng.normal(size=(8,)).astype(np.float32)),
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _zeros(tree):
    return {k: _zeros(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def _leaves(tree):
    return list(_flatten_with_paths(tree).values())


# ---------------------------------------------------------------------- #
# tests/test_runtime.py's checkpoint cases
# ---------------------------------------------------------------------- #
def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, async_write=False)
    tree = _tree()
    mgr.save(100, tree, extra={"loss": 1.5})
    assert mgr.latest_step() == 100
    restored = mgr.restore(_zeros(tree))
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert mgr.manifest()["extra"]["loss"] == 1.5
    assert all(v["spec"] is None for v in mgr.manifest()["keys"].values())


def test_checkpoint_async_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_n=2, async_write=True)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    mgr.wait()
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert len(steps) == 2
    assert mgr.latest_step() == 4
    r = mgr.restore(_tree(), step=4)
    assert torch.equal(r["head"], _tree(4)["head"])


def test_checkpoint_crash_safety(tmp_path):
    """A stale temp dir must not corrupt LATEST."""
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save(10, _tree())
    (tmp_path / ".tmp_step_00000020_999").mkdir()
    assert mgr.latest_step() == 10
    mgr.restore(_tree(), step=10)


def test_async_save_copies_before_returning(tmp_path):
    """``save`` snapshots to host memory: an in-place update right after
    it (the optimizer's) does not reach the file."""
    mgr = CheckpointManager(tmp_path, async_write=True)
    tree = _tree()
    want = tree["layers"]["w"].clone()
    for _ in range(3):
        mgr.save(1, tree)
        tree["layers"]["w"].add_(1.0)
        mgr.wait()
        got = mgr.restore(_zeros(tree), step=1)["layers"]["w"]
        assert torch.equal(got, want)
        want = tree["layers"]["w"].clone()


def test_restore_follows_the_template(tmp_path):
    """Tensor leaves come back on the template leaf's device in the saved
    dtype, numpy leaves as numpy arrays, lists as lists."""
    mgr = CheckpointManager(tmp_path, async_write=False)
    tree = {"a": [torch.arange(3), torch.ones(2, dtype=torch.float64)],
            "b": np.full((2, 2), 3, np.int16)}
    mgr.save(1, tree)
    keys = mgr.manifest()["keys"]
    assert list(keys) == ["a/0", "a/1", "b"]
    assert keys["b"] == {"shape": [2, 2], "dtype": "int16", "spec": None}
    out = mgr.restore({"a": [torch.zeros(3, dtype=torch.int64),
                             torch.zeros(2)], "b": np.zeros(1)})
    assert isinstance(out["a"], list) and out["a"][1].dtype == torch.float64
    assert torch.equal(out["a"][0], torch.arange(3))
    assert isinstance(out["b"], np.ndarray) and out["b"].dtype == np.int16


def test_bf16_leaves_are_refused(tmp_path):
    mgr = CheckpointManager(tmp_path, async_write=False)
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.save(1, {"w": torch.zeros(2, dtype=torch.bfloat16)})
    assert mgr.latest_step() is None


# ---------------------------------------------------------------------- #
# tests/test_checkpoint_recovery.py on the port's backends
# ---------------------------------------------------------------------- #
INDEX_BACKENDS = ["batched", "soa", "soa-device", "sharded"]


def _cfg(backend, seed=0):
    if backend == "sharded":
        return ClusterConfig(d=4, k=6, t=6, eps=0.5, seed=seed,
                             backend="sharded", shards=2,
                             inner_backend="batched")
    return ClusterConfig(d=4, k=6, t=6, eps=0.5, seed=seed, backend=backend)


def _make_index(backend, seed=0):
    X, _ = blobs(n=150, d=4, n_clusters=3, cluster_std=0.15, seed=seed)
    index = build_index(_cfg(backend, seed), device="cpu")
    index.insert_batch(X)
    return index


class _Boom(RuntimeError):
    pass


def _crash_rename_on(monkeypatch, needle: str):
    real = pathlib.Path.rename

    def rename(self, target):
        if needle in str(target):
            raise _Boom(f"simulated crash renaming to {target}")
        return real(self, target)

    monkeypatch.setattr(pathlib.Path, "rename", rename)


@pytest.mark.parametrize("backend", INDEX_BACKENDS)
@pytest.mark.parametrize("crash_at", ["index_00000002", "LATEST_INDEX"])
def test_crashed_save_index_keeps_previous_snapshot(tmp_path, monkeypatch,
                                                    crash_at, backend):
    index = _make_index(backend)
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save_index(1, index)
    labels_before = index.labels()

    index.insert(np.zeros(4))
    _crash_rename_on(monkeypatch, crash_at)
    with pytest.raises(_Boom):
        mgr.save_index(2, index)
    monkeypatch.undo()

    debris = (list(tmp_path.glob(".tmp_index_00000002_*"))
              + list(tmp_path.glob("LATEST_INDEX.tmp")))
    assert debris, "expected a leftover temp dir / tmp pointer"
    assert mgr.latest_index_step() == 1
    restored = mgr.restore_index(device="cpu")
    restored.check_invariants()
    assert restored.labels() == labels_before

    mgr.save_index(3, index)
    assert mgr.latest_index_step() == 3
    assert mgr.restore_index(device="cpu").labels() == index.labels()


def test_crash_before_first_save_means_no_checkpoint(tmp_path, monkeypatch):
    index = _make_index("soa")
    mgr = CheckpointManager(tmp_path, async_write=False)
    _crash_rename_on(monkeypatch, "index_00000001")
    with pytest.raises(_Boom):
        mgr.save_index(1, index)
    monkeypatch.undo()
    assert mgr.latest_index_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore_index()


def test_index_checkpoints_keep_n(tmp_path):
    index = _make_index("soa")
    mgr = CheckpointManager(tmp_path, keep_n=2, async_write=False)
    for s in (1, 2, 3):
        mgr.save_index(s, index)
    assert sorted(p.name for p in tmp_path.glob("index_*")) == [
        "index_00000002", "index_00000003"]


def test_restore_index_takes_the_device(tmp_path):
    """A soa-device index restores onto the device asked for; the
    default is the card, which this machine may not have."""
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save_index(1, _make_index("soa-device"))
    restored = mgr.restore_index(device="cpu")
    assert restored.labels() == _make_index("soa-device").labels()
    if not torch.cuda.is_available():
        with pytest.raises(Exception):
            mgr.restore_index()


# ---------------------------------------------------------------------- #
# interchange with repro's manager
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", INDEX_BACKENDS)
def test_index_directory_from_the_port_restores_in_repro(tmp_path, backend):
    index = _make_index(backend, seed=2)
    index.delete_batch(list(range(0, 150, 7)))
    CheckpointManager(tmp_path, async_write=False).save_index(5, index)
    restored = JaxManager(tmp_path, async_write=False).restore_index()
    restored.check_invariants()
    assert restored.labels() == index.labels()


@pytest.mark.parametrize("backend", INDEX_BACKENDS)
def test_index_directory_from_repro_restores_in_the_port(tmp_path, backend):
    X, _ = blobs(n=150, d=4, n_clusters=3, cluster_std=0.15, seed=4)
    cfg = dataclasses.asdict(_cfg(backend, seed=4))
    index = jax_build_index(JaxConfig(**cfg))
    index.insert_batch(X)
    index.delete_batch(list(range(0, 150, 5)))
    JaxManager(tmp_path, async_write=False).save_index(9, index)
    mgr = CheckpointManager(tmp_path, async_write=False)
    assert mgr.latest_index_step() == 9
    restored = mgr.restore_index(device="cpu")
    restored.check_invariants()
    assert restored.labels() == index.labels()
    # the restored index goes on: one more batch, equal labels again
    Y, _ = blobs(n=40, d=4, n_clusters=3, cluster_std=0.15, seed=5)
    assert restored.insert_batch(Y) == index.insert_batch(Y)
    assert restored.labels() == index.labels()


def test_step_directories_hold_the_same_arrays(tmp_path):
    tree = _tree(3)
    CheckpointManager(tmp_path / "port", async_write=False).save(
        4, tree, extra={"x": 1})
    JaxManager(tmp_path / "jax", async_write=False).save(
        4, {k: jax.tree.map(lambda t: jnp.asarray(t.numpy()), v)
            if isinstance(v, dict) else jnp.asarray(v.numpy())
            for k, v in tree.items()}, extra={"x": 1})
    mans = [json.loads((tmp_path / d / "step_00000004" /
                        "manifest.json").read_text())
            for d in ("port", "jax")]
    for m in mans:
        m.pop("time")
    assert mans[0] == mans[1]
    zs = [np.load(tmp_path / d / "step_00000004" / "shard_00000.npz")
          for d in ("port", "jax")]
    assert zs[0].files == zs[1].files
    for k in zs[0].files:
        assert zs[0][k].dtype == zs[1][k].dtype
        np.testing.assert_array_equal(zs[0][k], zs[1][k])


def test_jax_step_directory_loads_into_the_port(tmp_path):
    """repro's manager writes the smoke granite model and its AdamW
    state; the port restores it under a numpy template of the same
    nesting, splits the stacked layers and computes the JAX loss."""
    from repro.optim import AdamW, warmup_cosine

    jcfg = dataclasses.replace(jax_get_config("granite-20b").smoke(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("granite-20b").smoke(),
                               dtype="float32")
    jm = jax_build(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(1))
    opt = AdamW(lr=warmup_cosine(1e-3, 2, 10))
    JaxManager(tmp_path, async_write=False).save(
        12, {"params": jp, "opt": opt.init(jp)})
    template = jax.tree.map(lambda a: np.zeros(0), {
        "params": jp, "opt": opt.init(jp)})
    mgr = CheckpointManager(tmp_path, async_write=False)
    assert mgr.latest_step() == 12
    state = mgr.restore(template)
    assert int(state["opt"]["step"]) == 0
    params = params_from_jax(state["params"], tcfg, "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab_size, (2, 16)).astype(np.int32)
    jl, _ = jm.loss(jp, {"tokens": jnp.asarray(toks),
                         "labels": jnp.asarray(toks)})
    tl, _ = build_model(tcfg, device="cpu").loss(
        params, {"tokens": torch.from_numpy(toks).long(),
                 "labels": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4, atol=1e-5)


def test_port_step_directory_loads_into_repro(tmp_path):
    """The reverse: the port's parameter tree (layers as a list) restores
    in repro under a template of the same nesting."""
    tcfg = dataclasses.replace(get_config("granite-20b").smoke(),
                               dtype="float32")
    params = build_model(tcfg, device="cpu").init(3)
    CheckpointManager(tmp_path, async_write=False).save(2, params)
    template = jax.tree.map(lambda _: jnp.zeros(0), params,
                            is_leaf=lambda x: isinstance(x, torch.Tensor))
    out = JaxManager(tmp_path, async_write=False).restore(template)
    got = jax.tree.leaves(out)
    want = list(_flatten_with_paths(params).values())
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
