"""The port's serving engine against the JAX package's, on the CPU.

Both engines serve the same requests with the same parameters (drawn by
``repro``'s init and carried over by ``params_from_jax``) at float32:
every request must get the same ``out_tokens`` — greedy argmax over
logits that agree to ~1e-6 (``tests/test_torch_models.py``) — and, with
request clustering on the ``soa`` backend on both sides, the same
``cluster``; so do the paper's engines (``batched``, the default, and
``dynamic``).  Also: a request's output does not depend on the requests
sharing its batch (the port's counterpart of
``tests/test_pipeline_serving.py::test_serving_engine_isolation_between_slots``),
and ``python -m repro_torch.launch.serve --smoke --device cpu`` runs
(on its default arch, ``mamba2-780m``).
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.registry import build_model as jax_build  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.obs import make_obs  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

_MODELS = {}


def _models(arch, n_layers=None):
    key = (arch, n_layers)
    if key not in _MODELS:
        changes = {"dtype": "float32"}
        if n_layers:
            changes["n_layers"] = n_layers
        jcfg = dataclasses.replace(jax_get_config(arch).smoke(), **changes)
        tcfg = dataclasses.replace(get_config(arch).smoke(), **changes)
        jm = jax_build(jcfg)
        jp, _ = jm.init(jax.random.PRNGKey(7))
        tm = build_model(tcfg, device="cpu")
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
        _MODELS[key] = (jm, jp, tm, tp)
    return _MODELS[key]


def _requests(n, vocab, seed, lo=2, hi=8, max_new=6, embed=False):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(3, 8)) * 3
    out = []
    for rid in range(n):
        prompt = rng.integers(1, vocab, size=int(rng.integers(lo, hi)))
        emb = (centers[rid % 3] + 0.05 * rng.normal(size=8)) if embed \
            else None
        out.append((rid, prompt, max_new, emb))
    return out


def _serve(engine_cls, request_cls, model, params, reqs, **kw):
    eng = engine_cls(model, params, **kw)
    for rid, prompt, max_new, emb in reqs:
        eng.submit(request_cls(rid=rid, prompt=prompt,
                               max_new_tokens=max_new, embedding=emb))
    done = eng.run_until_drained(max_steps=500)
    eng.close()
    return done


@pytest.mark.parametrize("arch,n_layers,kv_len,hi", [
    ("granite-20b", None, 32, 8),
    ("gemma3-27b", 6, 64, 44),   # prompts past the 32-token window
])
def test_engine_matches_jax_engine_f32(arch, n_layers, kv_len, hi):
    jm, jp, tm, tp = _models(arch, n_layers)
    reqs = _requests(7, tm.cfg.vocab_size, seed=1, hi=hi)
    kw = dict(batch=3, kv_len=kv_len)
    jdone = _serve(JEngine, JRequest, jm, jp, reqs, **kw)
    tdone = _serve(ServingEngine, Request, tm, tp, reqs, **kw)
    assert sorted(tdone) == sorted(jdone) == list(range(7))
    for rid in jdone:
        assert tdone[rid].out_tokens == jdone[rid].out_tokens, rid
        assert len(tdone[rid].out_tokens) == 6


def test_engine_releases_at_eos_and_kv_len_like_jax():
    jm, jp, tm, tp = _models("granite-20b")
    reqs = _requests(5, tm.cfg.vocab_size, seed=4, lo=4, hi=12, max_new=40)
    jdone = _serve(JEngine, JRequest, jm, jp, reqs, batch=2, kv_len=24)
    first = jdone[0].out_tokens
    kw = dict(batch=2, kv_len=24, eos_id=first[2])
    jdone = _serve(JEngine, JRequest, jm, jp, reqs, **kw)
    tdone = _serve(ServingEngine, Request, tm, tp, reqs, **kw)
    assert {r: d.out_tokens for r, d in tdone.items()} == \
        {r: d.out_tokens for r, d in jdone.items()}
    assert tdone[0].out_tokens[-1] == first[2]
    # max_len release: prompt + outputs stop one short of kv_len
    for rid, prompt, _, _ in reqs:
        assert len(prompt) + len(tdone[rid].out_tokens) <= 24


def test_clustered_serving_matches_jax_soa():
    """Request clustering on the host ``soa`` backend on both sides: the
    same clusters, the same schedule and so the same tokens."""
    jm, jp, tm, tp = _models("granite-20b")
    reqs = _requests(14, tm.cfg.vocab_size, seed=2, embed=True)
    # batch 4: the admission window of 4 * batch = 16 requests holds
    # enough of each centre for k = 4
    kw = dict(batch=4, kv_len=32, cluster_requests=True,
              cluster_backend="soa")
    jdone = _serve(JEngine, JRequest, jm, jp, reqs, **kw)
    tdone = _serve(ServingEngine, Request, tm, tp, reqs, **kw)
    assert sorted(tdone) == list(range(14))
    for rid in jdone:
        assert tdone[rid].cluster == jdone[rid].cluster, rid
        assert tdone[rid].out_tokens == jdone[rid].out_tokens, rid
    # the three embedding centres give three clusters
    assert len({d.cluster for d in tdone.values()}) == 3


def test_engine_isolation_between_slots():
    """A request's output must not depend on which other requests share
    the batch (active-mask correctness)."""
    cfg = dataclasses.replace(get_config("granite-20b").smoke(),
                              dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(1)
    prompt = np.array([5, 9, 3], dtype=np.int64)

    def run(extra):
        eng = ServingEngine(model, params, batch=4, kv_len=32)
        eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=5))
        for rid, p in enumerate(extra, start=1):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=5))
        return eng.run_until_drained(max_steps=200)[0].out_tokens

    alone = run([])
    crowded = run([np.array([7, 7]), np.array([1, 2, 3, 4])])
    assert alone == crowded


def test_engine_obs_and_clusterer_device():
    cfg = get_config("gemma3-27b").smoke()
    model = build_model(cfg, device="cpu")
    obs = make_obs(True)
    eng = ServingEngine(model, model.init(0), batch=2, kv_len=40,
                        cluster_requests=True, cluster_backend="soa-device",
                        obs=obs)
    assert eng.clusterer.engine.device.type == "cpu"
    for rid, prompt, max_new, emb in _requests(
            5, cfg.vocab_size, seed=3, hi=36, embed=True):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=max_new,
                           embedding=emb))
    done = eng.run_until_drained()
    assert sorted(done) == list(range(5))
    snap = obs.snapshot()["metrics"]
    assert snap["serving.step_us"]["count"] >= 6
    assert snap["serving.submit_us"]["count"] == 5
    assert all(d.cluster is not None for d in done.values())


@pytest.mark.parametrize("backend", [None, "dynamic"],
                         ids=["batched-default", "dynamic"])
def test_clustered_serving_matches_jax_dict_engines(backend):
    """Request clustering on the paper's engines on both sides: the
    default backend (``batched``, no ``cluster_backend`` given) and
    ``dynamic`` give the same clusters (forest roots), schedule and
    tokens as the JAX engine."""
    jm, jp, tm, tp = _models("granite-20b")
    reqs = _requests(14, tm.cfg.vocab_size, seed=2, embed=True)
    kw = dict(batch=4, kv_len=32, cluster_requests=True)
    if backend is not None:
        kw["cluster_backend"] = backend
    jdone = _serve(JEngine, JRequest, jm, jp, reqs, **kw)
    tdone = _serve(ServingEngine, Request, tm, tp, reqs, **kw)
    assert sorted(tdone) == list(range(14))
    for rid in jdone:
        assert tdone[rid].cluster == jdone[rid].cluster, rid
        assert tdone[rid].out_tokens == jdone[rid].out_tokens, rid
    # the three embedding centres give three clusters
    assert len({d.cluster for d in tdone.values()}) == 3
    eng = ServingEngine(tm, tp, **kw)
    assert type(eng.clusterer.engine).__name__ == (
        "DynamicDBSCAN" if backend else "BatchedDynamicDBSCAN")
    assert not getattr(eng.clusterer.engine, "use_device", False)


def test_engine_gives_its_device_only_to_device_backends(monkeypatch):
    """The model's device goes to ``batched-device`` / ``soa-device``;
    a host backend gets ``None``, so the default works on the card."""
    from repro_torch.serving import engine as serving_engine

    seen = {}

    def recording_build(cfg, device=None):
        seen[cfg.backend] = device
        return object()

    monkeypatch.setattr(serving_engine, "build_index", recording_build)
    on_card = types.SimpleNamespace(device=torch.device("cuda"),
                                    decode_init=lambda b, kv_len: None)
    for backend in (None, "dynamic", "soa", "batched-device", "soa-device"):
        kw = {} if backend is None else {"cluster_backend": backend}
        ServingEngine(on_card, None, batch=2, kv_len=16,
                      cluster_requests=True, **kw)
    assert seen == {"batched": None, "dynamic": None, "soa": None,
                    "batched-device": "cuda", "soa-device": "cuda"}


@pytest.mark.parametrize("backend", ["soa-device", "batched"])
def test_sharded_clustered_serving_matches_jax(backend):
    """``cluster_shards=2``: the request-clustering index is ``sharded``
    over ``backend`` on both sides (the port's ``soa-device`` shards on
    the model's device, here the CPU), with the same clusters, schedule
    and tokens as the JAX engine."""
    jm, jp, tm, tp = _models("granite-20b")
    reqs = _requests(14, tm.cfg.vocab_size, seed=2, embed=True)
    kw = dict(batch=4, kv_len=32, cluster_requests=True,
              cluster_backend=backend, cluster_shards=2)
    jdone = _serve(JEngine, JRequest, jm, jp, reqs, **kw)
    tdone = _serve(ServingEngine, Request, tm, tp, reqs, **kw)
    assert sorted(tdone) == list(range(14))
    for rid in jdone:
        assert tdone[rid].cluster == jdone[rid].cluster, rid
        assert tdone[rid].out_tokens == jdone[rid].out_tokens, rid
    assert len({d.cluster for d in tdone.values()}) == 3
    eng = ServingEngine(tm, tp, **kw)
    try:
        assert eng.clusterer.cfg.backend == "sharded"
        assert eng.clusterer.cfg.inner_backend == backend
        assert len(eng.clusterer.clients) == 2
        if backend == "soa-device":
            assert all(ix.engine.device.type == "cpu"
                       for ix in eng.clusterer.inners)
    finally:
        eng.close()


def test_engine_gives_its_device_to_sharded_device_shards(monkeypatch):
    """With ``cluster_shards > 1`` the model's device goes to the sharded
    index when its shards run a device backend, else ``None``."""
    from repro_torch.serving import engine as serving_engine

    seen = {}

    def recording_build(cfg, device=None):
        seen[(cfg.backend, cfg.inner_backend)] = device
        return object()

    monkeypatch.setattr(serving_engine, "build_index", recording_build)
    on_card = types.SimpleNamespace(device=torch.device("cuda"),
                                    decode_init=lambda b, kv_len: None)
    for backend in ("soa", "batched", "soa-device", "batched-device"):
        ServingEngine(on_card, None, batch=2, kv_len=16,
                      cluster_requests=True, cluster_backend=backend,
                      cluster_shards=2, cluster_transport="process")
    assert seen == {("sharded", "soa"): None, ("sharded", "batched"): None,
                    ("sharded", "soa-device"): "cuda",
                    ("sharded", "batched-device"): "cuda"}


def test_no_silent_host_fallback_for_a_device():
    """An explicit device on a host backend still raises, and a device
    backend on a card that is not there raises rather than run on the
    host."""
    from repro_torch.api import build_index

    with pytest.raises(ValueError, match="host only"):
        build_index("batched", d=8, k=4, t=6, eps=0.6, device="cuda")
    if torch.cuda.is_available():
        return
    on_card = types.SimpleNamespace(device=torch.device("cuda"),
                                    decode_init=lambda b, kv_len: None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(on_card, None, batch=2, kv_len=16,
                      cluster_requests=True,
                      cluster_backend="batched-device")


def test_serve_cli_runs_on_cpu(capsys, monkeypatch):
    """The default arch is the reference's, ``mamba2-780m``."""
    built = []

    def spy(cfg, device=None):
        built.append(cfg.name)
        return build_model(cfg, device)

    monkeypatch.setattr(serve, "build_model", spy)
    done = serve.main(["--smoke", "--device", "cpu", "--requests", "5",
                       "--max-new", "3"])
    assert built == ["mamba2-780m"]
    assert sorted(done) == list(range(5))
    assert "served 5 requests, 15 tokens" in capsys.readouterr().out
    done = serve.main(["--arch", "gemma3-27b", "--smoke", "--device", "cpu",
                       "--requests", "4", "--cluster",
                       "--cluster-backend", "soa"])
    assert all(d.cluster is not None for d in done.values())


def test_serve_cli_cluster_default_matches_jax(capsys):
    """``--cluster`` without ``--cluster-backend`` runs on ``batched``
    and gives the JAX launcher's clusters (the embeddings and the
    schedule come from the same seed; no EOS, so the same releases)."""
    from repro.launch import serve as jax_serve

    argv = ["--arch", "granite-20b", "--smoke", "--requests", "6",
            "--max-new", "3", "--cluster"]
    done = serve.main(argv + ["--device", "cpu"])
    jdone = jax_serve.main(argv)
    assert "served 6 requests, 18 tokens" in capsys.readouterr().out
    assert {r: d.cluster for r, d in done.items()} == \
        {r: d.cluster for r, d in jdone.items()}
    assert all(d.cluster is not None for d in done.values())


def test_serve_cli_sharded_soa_device_matches_jax(capsys):
    """``--cluster --cluster-shards 2 --cluster-backend soa-device``: the
    sharded clustering index with its device shards on ``--device``
    groups the requests as the JAX launcher's sharded default
    (``batched`` shards, which has no ``--cluster-backend``) does: the
    same exact partition, under other opaque labels."""
    from repro.launch import serve as jax_serve

    argv = ["--arch", "granite-20b", "--smoke", "--requests", "6",
            "--max-new", "3", "--cluster", "--cluster-shards", "2"]
    done = serve.main(argv + ["--device", "cpu",
                              "--cluster-backend", "soa-device"])
    jdone = jax_serve.main(argv)
    assert "served 6 requests, 18 tokens" in capsys.readouterr().out

    def groups(d):
        by = {}
        for rid, req in d.items():
            by.setdefault(req.cluster, set()).add(rid)
        return sorted(sorted(g) for g in by.values())

    assert groups(done) == groups(jdone)
    assert all(d.cluster is not None for d in done.values())


def test_tiered_serving_runs_on_the_host_and_closes():
    """``cluster_tier=0.2`` builds the tiered index (``approx`` front,
    ``soa`` back, both host) and hands it no device, on a card too; every
    request is labelled, the tokens equal the JAX engine's with the same
    tier (a request's tokens do not depend on its batch), the ``tiered.*``
    gauges reach the clusterer's obs, and ``close()`` stops the verifier
    thread."""
    from repro_torch.serving import engine as serving_engine
    from repro_torch.tiered import TieredIndex

    jm, jp, tm, tp = _models("granite-20b")
    reqs = _requests(14, tm.cfg.vocab_size, seed=2, embed=True)
    kw = dict(batch=4, kv_len=32, cluster_requests=True, cluster_tier=0.2)
    jdone = _serve(JEngine, JRequest, jm, jp, reqs, **kw)
    eng = ServingEngine(tm, tp, obs=make_obs(True), **kw)
    try:
        assert isinstance(eng.clusterer, TieredIndex)
        assert eng.clusterer.cfg.sample_rate == 0.2
        assert eng.clusterer.verifier.is_alive()
        for rid, prompt, max_new, emb in reqs:
            eng.submit(Request(rid=rid, prompt=prompt,
                               max_new_tokens=max_new, embedding=emb))
        done = eng.run_until_drained(max_steps=500)
        assert sorted(done) == list(range(14))
        assert all(d.cluster is not None for d in done.values())
        for rid in jdone:
            assert done[rid].out_tokens == jdone[rid].out_tokens, rid
        eng.clusterer.exact_labels()  # barrier
        m = eng.clusterer.obs.snapshot()["metrics"]
        assert m["tiered.lag"]["value"] == 0
        assert 0.0 <= m["tiered.divergence_ari"]["value"] <= 1.0
    finally:
        eng.close()
    assert not eng.clusterer.verifier.is_alive()

    seen = {}

    def recording_build(cfg, device=None):
        seen[cfg.backend] = device
        return object()

    on_card = types.SimpleNamespace(device=torch.device("cuda"),
                                    decode_init=lambda b, kv_len: None)
    real = serving_engine.build_index
    serving_engine.build_index = recording_build
    try:
        ServingEngine(on_card, None, batch=2, kv_len=16,
                      cluster_requests=True, cluster_tier=0.2)
    finally:
        serving_engine.build_index = real
    assert seen == {"tiered": None}


def test_serve_cli_tier_runs_on_cpu(capsys):
    done = serve.main(["--smoke", "--device", "cpu", "--requests", "6",
                       "--max-new", "3", "--cluster", "--tier", "0.2"])
    assert sorted(done) == list(range(6))
    assert all(d.cluster is not None for d in done.values())
    assert "served 6 requests, 18 tokens" in capsys.readouterr().out
