"""``repro_torch.analysis``, the port's static-analysis suite, held to
``tests/test_analysis.py``'s cases on fixture trees under a
``repro_torch``-named package, and to the reference's passes wherever a
rule carries over unchanged (CONC, FT, OBS, HOT101-103, PROTO): the same
fixture gives the same ``(rule, path, line)`` set under both.  Then the
port's own contracts: the hot-path pass's device scope (PyTorch's host
syncs flagged in a ``kernels/`` wrapper; the build modules and the
launch ABI's host scalars not), REG005's ``(cfg, device)`` factories,
the live closure of the port's ClusterIndex, and the port's tree kept
analysis-clean by ``python -m repro_torch.analysis`` in a process that
imports neither JAX nor ``repro``.

AST work and reflection only; no kernel or engine runs here.
"""

import abc
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.analysis.concurrency_pass import \
    ConcurrencyGuards as RefConcurrency  # noqa: E402
from repro.analysis.fault_pass import \
    FaultToleranceGuards as RefFault  # noqa: E402
from repro.analysis.hotpath_pass import HotPathPurity as RefHot  # noqa: E402
from repro.analysis.obs_pass import ObsDiscipline as RefObs  # noqa: E402
from repro.analysis.protocol_pass import \
    ProtocolExhaustiveness as RefProtocol  # noqa: E402
from repro.analysis.walker import Project as RefProject  # noqa: E402
from repro_torch.analysis import cli  # noqa: E402
from repro_torch.analysis.concurrency_pass import \
    ConcurrencyGuards  # noqa: E402
from repro_torch.analysis.fault_pass import FaultToleranceGuards  # noqa: E402
from repro_torch.analysis.hotpath_pass import HotPathPurity  # noqa: E402
from repro_torch.analysis.obs_pass import ObsDiscipline  # noqa: E402
from repro_torch.analysis.protocol_pass import \
    ProtocolExhaustiveness  # noqa: E402
from repro_torch.analysis.registry_pass import (  # noqa: E402
    RegistryConformance, _subclass_closure)
from repro_torch.analysis.walker import Project, SourceFile  # noqa: E402

REPO_ROOT = Path(__file__).resolve().parent.parent
PKG = "repro_torch"


def make_project(tmp_path, files):
    """Build a fixture tree: {relpath-under-repro_torch: source} ->
    Project."""
    for rel, text in files.items():
        p = tmp_path / PKG / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return Project(tmp_path)


def rules(findings):
    return sorted(f.rule for f in findings)


def located(findings):
    return sorted((f.rule, f.path, f.line) for f in findings)


# ---------------------------------------------------------------------- #
# walker: pragmas and parent links
# ---------------------------------------------------------------------- #
class TestWalker:
    def test_allow_pragma_same_line_and_line_above(self):
        sf = SourceFile(
            "x = 1  # analysis: allow[R1,R2]\n"
            "# analysis: allow[R3]\n"
            "y = 2\n"
            "z = 3\n", "m.py")
        assert sf.suppressed(1, "R1") and sf.suppressed(1, "R2")
        assert not sf.suppressed(1, "R9")
        assert sf.suppressed(3, "R3")  # pragma on the line above
        assert not sf.suppressed(4, "R3")  # does not leak downward

    def test_allow_star_suppresses_everything(self):
        sf = SourceFile("x = 1  # analysis: allow[*]\n", "m.py")
        assert sf.suppressed(1, "ANY999")

    def test_hot_path_pragma_positions(self):
        sf = SourceFile(textwrap.dedent("""\
            # hot-path
            def above():
                pass

            def trailing():  # hot-path
                pass

            def cold():
                pass
            """), "m.py")
        fns = {f.name: f for f in sf.functions()}
        assert sf.is_hot_path(fns["above"])
        assert sf.is_hot_path(fns["trailing"])
        assert not sf.is_hot_path(fns["cold"])

    def test_project_skips_unparseable(self, tmp_path):
        project = make_project(tmp_path, {"ok.py": "x = 1\n",
                                          "bad.py": "def broken(:\n"})
        assert [sf.rel for sf in project.sources()] == ["ok.py"]

    def test_project_defaults_to_the_port(self):
        project = Project.locate()
        assert project.package == PKG
        assert project.root == REPO_ROOT / "src"
        assert project.source("analysis/walker.py") is not None


# ---------------------------------------------------------------------- #
# the fixtures of the rules that carry over unchanged
# ---------------------------------------------------------------------- #
BAD_HOT = """\
    import numpy as np

    # hot-path
    def resolve(ids, pts):
        out = []
        for i in ids:
            v = np.asarray(pts[i])
            out.append({"id": i, "v": v})
        return out
"""

BAD_FANOUT = """\
    class Coordinator:
        def insert(self, s, X):
            self._fanout({
                s: (lambda s=s: self.bridge.insert(s)),
            })

        def rehome(self, s, i):
            self.pool.submit(lambda: self._assign(i))

        def _assign(self, i):
            pass

    def _mk(self):
        return lambda i=0: self.clients[i].insert_batch([])
"""

#: name -> (pass name, fixture files, the rules the fixture gives)
FIXTURES = {
    "hot-pragma": ("hot-path-purity", {"shard/hot.py": BAD_HOT},
                   ["HOT101", "HOT103"]),
    "hot-unmarked": ("hot-path-purity", {
        "shard/cold.py": BAD_HOT.replace("# hot-path", "")}, []),
    "hot-suppressed": ("hot-path-purity", {"shard/hot.py": BAD_HOT.replace(
        "v = np.asarray(pts[i])",
        "v = np.asarray(pts[i])  # analysis: allow[HOT101]")}, ["HOT103"]),
    "hot-item": ("hot-path-purity", {"service/fast.py": """\
        def label(ix, i):  # hot-path
            return ix.labels[i].item()
    """}, ["HOT102"]),
    "conc-owned": ("concurrency-guards", {"shard/index.py": BAD_FANOUT},
                   ["CONC001"]),
    "conc-reads": ("concurrency-guards", {"shard/index.py": """\
        class C:
            def labels(self, ids):
                return self._fanout({
                    0: (lambda: self.clients[0].labels(ids)),
                    1: (lambda: self.bridge.lookup(ids)),
                })
    """}, []),
    "conc-local-def": ("concurrency-guards", {"shard/index.py": """\
        class C:
            def go(self, s):
                def work():
                    self._cache = None
                self.pool.submit(lambda: work())
    """}, []),
    "conc-bare": ("concurrency-guards", {"service/transport.py": """\
        def request(sock):
            try:
                return sock.recv(1)
            except:
                raise RuntimeError("boom")
    """}, ["CONC002", "CONC003"]),
    "conc-chained": ("concurrency-guards", {"service/transport.py": """\
        def request(sock):
            try:
                return sock.recv(1)
            except OSError as e:
                if transient(e):
                    raise e
                raise RuntimeError("closed") from e
            except KeyError:
                raise ValueError("no shard") from None
    """}, []),
    "conc-scope": ("concurrency-guards", {"core/engine.py": """\
        def load(d):
            try:
                return d["k"]
            except KeyError:
                raise ValueError("bad state")
    """}, []),
    "ft-swallowed": ("fault-tolerance-guards", {"shard/index.py": """\
        def fanout(clients, req):
            out = []
            for c in clients:
                try:
                    out.append(c.request(req))
                except ShardUnavailableError:
                    out.append(None)  # dead shard -> wrong answers
            return out
    """}, ["FT001"]),
    "ft-clean": ("fault-tolerance-guards", {"service/replica.py": """\
        class Lane:
            def mutate(self, req):
                try:
                    return self.primary.request(req)
                except ShardUnavailableError:
                    self._fail_member(self.primary)  # promote + evict
                    return self.primary.request(req)

            def query(self, req):
                try:
                    return self.primary.request(req)
                except ShardUnavailableError as e:
                    raise RuntimeError("lane dead") from e
    """}, []),
    "ft-tuple": ("fault-tolerance-guards", {"service/transport.py": """\
        def roundtrip(sock, req):
            try:
                return exchange(sock, req)
            except (OSError, transport.ShardUnavailableError):
                return None
    """}, ["FT001"]),
    "ft-nested": ("fault-tolerance-guards", {"shard/router.py": """\
        def route(c, req):
            try:
                return c.request(req)
            except ShardUnavailableError:
                try:
                    c.close()
                except OSError:
                    raise
                return None
    """}, ["FT001"]),
    "ft-scope": ("fault-tolerance-guards", {"serving/engine.py": """\
        def submit(c, req):
            try:
                return c.request(req)
            except ShardUnavailableError:
                return None
    """}, []),
    "ft-suppressed": ("fault-tolerance-guards", {"shard/index.py": """\
        def rollback(survivors, ids):
            for c in survivors:
                try:
                    c.delete_batch(ids)
                except ShardUnavailableError:  # analysis: allow[FT001]
                    pass  # double failure: counter is the record
    """}, []),
    "obs-open": ("obs-discipline", {"service/handler.py": """\
        class Svc:
            def handle(self, req):
                sp = self.obs.tracer.span("shard.op")  # stored, leaks
                sp.__enter__()
                t = self.h.timer()
                return req
    """}, ["OBS001", "OBS001"]),
    "obs-with": ("obs-discipline", {"shard/coord.py": """\
        class Coord:
            def insert(self, X):
                with self.obs.tracer.span("coord.insert", n=len(X)), \\
                        self._h_insert_us.timer():
                    return self._impl(X)

            def merge(self):
                with self.obs.tracer.span("bridge.merge"):
                    with self._h_merge_us.timer():
                        return self._merge_impl()
    """}, []),
    "obs-scope": ("obs-discipline", {"serving/loop.py": """\
        def tick(clock):
            t = clock.timer()
            return t.elapsed()
    """}, []),
    "obs-suppressed": ("obs-discipline", {"service/handler.py": """\
        def probe(h):
            t = h.timer()  # analysis: allow[OBS001]
            return t
    """}, []),
}

PORT_PASSES = {"hot-path-purity": HotPathPurity,
               "concurrency-guards": ConcurrencyGuards,
               "fault-tolerance-guards": FaultToleranceGuards,
               "obs-discipline": ObsDiscipline}
REF_PASSES = {"hot-path-purity": RefHot,
              "concurrency-guards": RefConcurrency,
              "fault-tolerance-guards": RefFault,
              "obs-discipline": RefObs}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_rules(tmp_path, name):
    """Each fixture gives the reference test's rules under the port."""
    pass_name, files, want = FIXTURES[name]
    found = PORT_PASSES[pass_name]().run(make_project(tmp_path, files))
    assert rules(found) == want


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_parity_with_the_reference(tmp_path, name):
    """The port's pass and the reference's give the same (rule, path,
    line) set on the same ``repro_torch`` fixture tree."""
    pass_name, files, _ = FIXTURES[name]
    make_project(tmp_path, files)
    mine = PORT_PASSES[pass_name]().run(Project(tmp_path))
    ref = REF_PASSES[pass_name]().run(RefProject(tmp_path, package=PKG))
    assert located(mine) == located(ref)
    assert [f.message for f in sorted(mine, key=lambda f: f.line)] == \
        [f.message for f in sorted(ref, key=lambda f: f.line)]


def test_concurrency_message_names_the_structure(tmp_path):
    found = ConcurrencyGuards().run(
        make_project(tmp_path, {"shard/index.py": BAD_FANOUT}))
    assert "bridge" in found[0].message


# ---------------------------------------------------------------------- #
# hot-path purity: the port's device scope
# ---------------------------------------------------------------------- #
BAD_KERNEL = """\
    import numpy as np

    def kernel(x, acc):
        for i in range(8):
            acc = acc + x
        y = np.asarray(acc)
        return float(y)
"""


class TestDeviceScope:
    def test_device_scope_flags_loop_sync_and_numpy(self, tmp_path):
        project = make_project(tmp_path, {"kernels/bad.py": BAD_KERNEL})
        assert rules(HotPathPurity().run(project)) == \
            ["HOT001", "HOT002", "HOT003"]

    def test_device_scope_clean_kernel(self, tmp_path):
        project = make_project(tmp_path, {"kernels/ok.py": """\
            import torch

            def kernel(x):
                return torch.sum(x * x)
        """})
        assert HotPathPurity().run(project) == []

    @pytest.mark.parametrize("call", [
        "x.item()", "x.tolist()", "x.cpu()", "x.numpy()",
        "torch.cuda.synchronize()", "int(x.sum())", "float(x.max())",
        "bool(x.any())"])
    def test_host_syncs_in_a_wrapper_are_flagged(self, tmp_path, call):
        project = make_project(tmp_path, {"kernels/wrap.py": f"""\
            import torch

            def wrapper(x):
                y = {call}
                return x
        """})
        found = HotPathPurity().run(project)
        assert rules(found) == ["HOT002"]
        assert found[0].line == 4 and "host sync" in found[0].message

    def test_launch_abi_scalars_are_host_values(self, tmp_path):
        """``int(k)`` as an argument of ``_build.launch`` is the launch
        ABI; the same conversion elsewhere, or a sync inside the
        argument list, is flagged."""
        project = make_project(tmp_path, {"kernels/wrap.py": """\
            from . import _build

            def wrapper(x, out, k, scale):
                _build.launch("kern", x.data_ptr(), int(k), float(scale),
                              int(k > 0), out.data_ptr())
                n = int(k)
                _build.launch("kern", x.data_ptr(), x.sum().item())
                return out
        """})
        found = HotPathPurity().run(project)
        assert located(found) == [("HOT002", "kernels/wrap.py", 6),
                                  ("HOT002", "kernels/wrap.py", 7)]

    def test_build_and_checks_are_host_modules(self, tmp_path):
        loop = """\
            def each(paths):
                for p in paths:
                    print(int(p))
        """
        project = make_project(tmp_path, {"kernels/_build.py": loop,
                                          "kernels/_checks.py": loop,
                                          "kernels/ops.py": loop})
        assert located(HotPathPurity().run(project)) == [
            ("HOT001", "kernels/ops.py", 2),
            ("HOT002", "kernels/ops.py", 3)]

    def test_the_reference_scope_differs_only_where_written(self, tmp_path):
        """On a kernels/ tree the reference flags the build modules'
        loops and the launch ABI; the port flags neither, and the rest
        alike."""
        make_project(tmp_path, {
            "kernels/_build.py": "def f(xs):\n    for x in xs:\n"
                                 "        pass\n",
            "kernels/wrap.py": "from . import _build\n\n"
                               "def g(x, k):\n"
                               "    _build.launch('e', int(k))\n"
                               "    return x.item()\n"})
        mine = located(HotPathPurity().run(Project(tmp_path)))
        ref = located(RefHot().run(RefProject(tmp_path, package=PKG)))
        assert mine == [("HOT002", "kernels/wrap.py", 5)]
        assert ref == [("HOT001", "kernels/_build.py", 2),
                       ("HOT002", "kernels/wrap.py", 4),
                       ("HOT002", "kernels/wrap.py", 5)]

    def test_suppression_pragma_with_a_reason(self, tmp_path):
        project = make_project(tmp_path, {"kernels/ref.py": """\
            def plain(x, d):
                # the fixed order of the sums over k
                for k in range(d):  # analysis: allow[HOT001]
                    x = x + k
                return x
        """})
        assert HotPathPurity().run(project) == []


# ---------------------------------------------------------------------- #
# protocol exhaustiveness
# ---------------------------------------------------------------------- #
FIXTURE_MESSAGES = """\
    import dataclasses
    from typing import Any, ClassVar, Dict, Optional, Tuple, Type

    import numpy as np

    MESSAGE_TYPES: Dict[str, type] = {}


    def register_message(cls):
        MESSAGE_TYPES[cls.kind] = cls
        return cls


    @dataclasses.dataclass
    class Message:
        kind: ClassVar[str] = ""
        _dtypes: ClassVar[Dict[str, Any]] = {}
        _poly_dtypes: ClassVar[Dict[str, Tuple[Any, ...]]] = {}
        _array_dicts: ClassVar[Tuple[str, ...]] = ()


    @register_message
    @dataclasses.dataclass
    class PingReq(Message):
        kind = "ping"
        _dtypes = {"ids": np.int64}
        ids: Optional[np.ndarray] = None


    @register_message
    @dataclasses.dataclass
    class PingResp(Message):
        kind = "ping_resp"
        n: int = 0


    @register_message
    @dataclasses.dataclass
    class OkResp(Message):
        kind = "ok"


    @dataclasses.dataclass
    class LostResp(Message):  # not registered -> PROTO001
        kind = "lost"


    @register_message
    @dataclasses.dataclass
    class BlobReq(Message):  # payload without dtype -> PROTO002
        kind = "blob"
        data: Optional[np.ndarray] = None


    @register_message
    @dataclasses.dataclass
    class TagsReq(Message):  # object dtype -> PROTO003
        kind = "tags"
        _dtypes = {"tags": np.object_}
        tags: Optional[np.ndarray] = None


    @register_message
    @dataclasses.dataclass
    class OrphanReq(Message):  # no dispatch entry -> PROTO004
        kind = "orphan"
"""

FIXTURE_SERVICE = """\
    from . import messages as m


    class FixtureService:
        def __init__(self, index):
            self.index = index
            self._dispatch = {
                m.PingReq: self._ping,
                m.BlobReq: lambda req: m.OkResp(),
                m.TagsReq: self._tags,
            }

        def _ping(self, req) -> m.OkResp:  # bypasses PingResp -> PROTO006
            return m.OkResp()

        def _tags(self, req):  # no resolvable response -> PROTO005
            return self.index.tags(req)
"""


def load_fixture_module(path: Path, name: str) -> types.ModuleType:
    mod = types.ModuleType(name)
    exec(compile(path.read_text(), str(path), "exec"), mod.__dict__)
    return mod


class TestProtocolExhaustiveness:
    @pytest.fixture
    def fixture_project(self, tmp_path):
        project = make_project(tmp_path, {
            "service/messages.py": FIXTURE_MESSAGES,
            "service/service.py": FIXTURE_SERVICE,
        })
        mod = load_fixture_module(
            tmp_path / PKG / "service" / "messages.py", "fixture_messages")
        return project, mod

    def test_all_rules_fire_on_seeded_fixture(self, fixture_project):
        project, mod = fixture_project
        found = ProtocolExhaustiveness(
            messages=mod, service_class="FixtureService").run(project)
        assert rules(found) == ["PROTO001", "PROTO002", "PROTO003",
                                "PROTO004", "PROTO005", "PROTO006"]
        by_rule = {f.rule: f for f in found}
        assert "LostResp" in by_rule["PROTO001"].message
        assert "BlobReq.data" in by_rule["PROTO002"].message
        assert "TagsReq.tags" in by_rule["PROTO003"].message
        assert "OrphanReq" in by_rule["PROTO004"].message
        assert "PingResp" in by_rule["PROTO006"].message
        assert all(f.path.endswith(".py") and f.line > 0 for f in found)

    def test_parity_with_the_reference(self, fixture_project, tmp_path):
        project, mod = fixture_project
        kw = dict(messages=mod, service_class="FixtureService")
        mine = ProtocolExhaustiveness(**kw).run(project)
        ref = RefProtocol(**kw).run(RefProject(tmp_path, package=PKG))
        assert located(mine) == located(ref)
        assert sorted(f.message for f in mine) == \
            sorted(f.message for f in ref)

    def test_port_protocol_is_clean(self):
        """The live pass reads the port's messages and its service."""
        from repro_torch.service import messages

        p = ProtocolExhaustiveness()
        assert p.run(Project.locate()) == []
        ssf = Project.locate().source("service/service.py")
        assert "class ClusterService" in ssf.text
        from repro_torch.analysis.protocol_pass import (_DispatchTable,
                                                        _message_classes)
        table = _DispatchTable(ssf)
        reqs = {n for n in _message_classes(messages) if n.endswith("Req")}
        assert reqs and reqs <= set(table.entries)

    def test_poly_dtypes_accepted_object_dtype_rejected(self):
        from repro_torch.service import messages as m
        resp = m.InsertBatchResp(
            ids=np.arange(3), digest=np.zeros((3, 2, 2), dtype=np.int32))
        assert resp.digest.dtype == np.int32
        with pytest.raises(TypeError, match="dtype"):
            m.InsertBatchResp(ids=np.arange(1),
                              digest=np.array([object()], dtype=object))

    def test_codec_refuses_object_arrays(self):
        from repro_torch.service import codec
        from repro_torch.service import messages as m
        snap = m.SnapshotResp(state={"k": np.array([{}], dtype=object)})
        with pytest.raises(TypeError, match="non-fixed dtype"):
            codec.encode(snap)


# ---------------------------------------------------------------------- #
# registry conformance
# ---------------------------------------------------------------------- #
class FixtureBase(abc.ABC):
    native_component_queries = False

    @abc.abstractmethod
    def insert(self, x):
        ...

    def core_anchor_of(self, idx):
        raise NotImplementedError

    def _state(self):
        return {}

    def _load_state(self, state):
        pass

    def snapshot(self):
        return {"state": self._state()}

    def restore(self, snap):
        self._load_state(snap["state"])


class GoodBackend(FixtureBase):
    native_component_queries = True

    def insert(self, x):
        return 0

    def core_anchor_of(self, idx):
        return idx

    def _state(self):
        return {"n": np.zeros(1)}

    def _load_state(self, state):
        pass


class StillAbstract(FixtureBase):  # REG001
    pass


class HalfPersistent(FixtureBase):  # REG002
    def insert(self, x):
        return 0

    def _state(self):
        return {"n": np.zeros(1)}


class FlagWithoutAnchor(FixtureBase):  # REG003
    native_component_queries = True

    def insert(self, x):
        return 0


class AnchorWithoutFlag(FixtureBase):  # REG004 (never mentions the flag)
    def insert(self, x):
        return 0

    def core_anchor_of(self, idx):
        return idx


def config_only(cfg):
    return GoodBackend()


def config_and_device(cfg, device):
    return GoodBackend()


def one_too_many(cfg, device, extra):
    return GoodBackend()


def device_by_default(cfg, device=None):
    return GoodBackend()


#: the port's ClusterIndex closure (the classes defined in repro_torch)
PORT_CLASSES = {"ApproxIndex", "EulerTourIndex", "FixedCoreIndex",
                "RecomputeIndex", "ShardedIndex", "SoAIndex", "TieredIndex"}


class TestRegistryConformance:
    def run_on(self, tmp_path, *classes, factories=None):
        project = make_project(tmp_path, {"__init__.py": ""})
        return RegistryConformance(
            classes=classes, base=FixtureBase,
            factories=factories).run(project)

    def test_good_backend_is_clean(self, tmp_path):
        assert self.run_on(tmp_path, GoodBackend) == []

    @pytest.mark.parametrize("cls,rule", [
        (StillAbstract, "REG001"), (HalfPersistent, "REG002"),
        (FlagWithoutAnchor, "REG003"), (AnchorWithoutFlag, "REG004")])
    def test_each_seeded_violation(self, tmp_path, cls, rule):
        found = self.run_on(tmp_path, cls)
        assert rules(found) == [rule], (cls.__name__, rules(found))
        assert cls.__name__ in found[0].message

    @pytest.mark.parametrize("factory,flagged", [
        (config_and_device, False), (config_only, True),
        (one_too_many, True), (device_by_default, True)])
    def test_reg005_states_the_cfg_device_contract(self, tmp_path, factory,
                                                   flagged):
        found = self.run_on(tmp_path, GoodBackend,
                            factories={"fixture": factory})
        assert rules(found) == (["REG005"] if flagged else [])
        if flagged:
            assert "'fixture'" in found[0].message
            assert "ClusterConfig and the device" in found[0].message

    def test_port_registry_is_clean(self):
        assert RegistryConformance().run(Project.locate()) == []

    def test_port_closure_and_factories(self):
        """The live closure has exactly the port's seven classes (test
        subclasses aside), and its eleven factories take (cfg, device)."""
        import inspect

        import repro_torch.shard  # noqa: F401
        import repro_torch.tiered  # noqa: F401
        from repro_torch.api import registry as reg
        from repro_torch.api.index import ClusterIndex

        names = {c.__name__ for c in _subclass_closure(ClusterIndex)
                 if c.__module__.startswith(PKG + ".")}
        assert names == PORT_CLASSES
        ours = {n: f for n, f in reg._REGISTRY.items()
                if f.__module__.startswith(PKG + ".")}
        assert len(ours) == 11
        for f in ours.values():
            assert list(inspect.signature(f).parameters) == ["cfg",
                                                             "device"]

    def test_tiered_backends_conform(self, tmp_path):
        from repro_torch.api.backends import ApproxIndex
        from repro_torch.api.index import ClusterIndex
        from repro_torch.tiered import TieredIndex

        project = make_project(tmp_path, {"__init__.py": ""})
        found = RegistryConformance(
            classes=(ApproxIndex, TieredIndex),
            base=ClusterIndex).run(project)
        assert found == [], rules(found)


# ---------------------------------------------------------------------- #
# CLI
# ---------------------------------------------------------------------- #
class TestCli:
    def test_exit_1_and_text_report_on_findings(self, tmp_path, capsys):
        make_project(tmp_path, {"kernels/bad.py": BAD_KERNEL})
        rc = cli.main(["--root", str(tmp_path),
                       "--select", "hot-path-purity"])
        out = capsys.readouterr().out
        assert rc == 1
        assert "kernels/bad.py" in out and "HOT001" in out
        assert out.splitlines()[-1] == "3 finding(s) from 1 pass(es)"

    def test_exit_0_and_json_on_clean_tree(self, tmp_path, capsys):
        make_project(tmp_path, {"core/ok.py": "x = 1\n"})
        rc = cli.main(["--root", str(tmp_path), "--json",
                       "--select", "hot-path-purity,concurrency-guards"])
        report = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert report["ok"] and report["n_findings"] == 0
        assert report["counts"] == {"hot-path-purity": 0,
                                    "concurrency-guards": 0}

    def test_json_report_shape(self, tmp_path, capsys):
        make_project(tmp_path, {"kernels/bad.py": BAD_KERNEL})
        cli.main(["--root", str(tmp_path), "--json",
                  "--select", "hot-path-purity"])
        report = json.loads(capsys.readouterr().out)
        assert not report["ok"]
        assert report["counts"] == {"hot-path-purity": report["n_findings"]}
        f = report["findings"][0]
        assert set(f) == {"pass_name", "rule", "path", "line", "message"}

    def test_unknown_pass_is_usage_error(self, tmp_path, capsys):
        rc = cli.main(["--root", str(tmp_path), "--select", "nope"])
        assert rc == 2
        assert "unknown pass" in capsys.readouterr().err

    def test_list_passes(self, capsys):
        assert cli.main(["--list"]) == 0
        out = capsys.readouterr().out
        for name in ("protocol-exhaustiveness", "hot-path-purity",
                     "concurrency-guards", "registry-conformance",
                     "obs-discipline", "fault-tolerance-guards"):
            assert name in out


# ---------------------------------------------------------------------- #
# the port itself stays clean
# ---------------------------------------------------------------------- #
def _imported(stderr: str) -> set:
    """Module names from ``-X importtime``'s report."""
    return {ln.rsplit("|", 1)[1].strip() for ln in stderr.splitlines()
            if ln.startswith("import time:") and ln.count("|") == 2}


def test_port_is_analysis_clean():
    """``python -m repro_torch.analysis`` exits 0 with ``0 finding(s)``
    over the port, and its process imports neither JAX nor ``repro``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO_ROOT / "src")
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "repro_torch.analysis"],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.splitlines()[-1] == "0 finding(s) from 6 pass(es)"
    mods = _imported(proc.stderr)
    assert "repro_torch.analysis.registry_pass" in mods
    assert "repro_torch.service.messages" in mods
    bad = sorted(m for m in mods if m.split(".")[0] in ("jax", "jaxlib",
                                                        "repro"))
    assert bad == []


def test_port_json_report_names_all_six_passes(capsys):
    assert cli.main(["--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] and report["findings"] == []
    assert report["counts"] == dict.fromkeys(
        ("concurrency-guards", "fault-tolerance-guards", "hot-path-purity",
         "obs-discipline", "protocol-exhaustiveness",
         "registry-conformance"), 0)
