"""registry-conformance — every backend honours the ClusterIndex protocol.

The backend registry is the repo's extension point: serving, sharding,
checkpointing, and the transports all assume any registered backend
upholds the full :class:`~repro_torch.api.index.ClusterIndex` contract.
The parts Python enforces (abstract methods) fail loudly; the parts it
does not — snapshot/restore symmetry and the ``native_component_queries``
capability flag that the sharded incremental merge trusts — fail as
wrong clusters months later.  This pass checks them by reflection over
the concrete ClusterIndex subclass closure:

  REG001  concrete-looking backend class still has abstract methods
  REG002  persistence overridden asymmetrically (``_state`` without
          ``_load_state``, or ``snapshot`` without ``restore``)
  REG003  ``native_component_queries`` is truthy but ``core_anchor_of``
          is inherited from the raising base — the advertised capability
          does not exist
  REG004  ``core_anchor_of`` is overridden but the class never declares
          ``native_component_queries`` (class attribute or instance
          assignment) — the capability exists but is never advertised,
          so the sharded merge silently falls back to rebuild-per-query
  REG005  registered factory does not take exactly two required
          parameters (the ClusterConfig and the device)

A port of ``repro.analysis.registry_pass`` over ``repro_torch.api``,
``repro_torch.shard`` and ``repro_torch.tiered``.  REG001-004 are the
reference's.  REG005 states the port's own contract: ``build_index``
calls ``factory(cfg, device)``, the device (``Optional[str]``, None for
the backend's default) being no config field in the port, so a factory
takes exactly those two required parameters where the reference's takes
the config alone.  Fixture tests inject the classes, the base and the
factories.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, Iterable, List, Optional

from .base import AnalysisPass, register_pass
from .findings import Finding
from .walker import Project, SourceFile

#: the required parameters of a registered factory: ``(cfg, device)``
FACTORY_PARAMS = 2


def _subclass_closure(base: type) -> List[type]:
    out, todo = [], [base]
    while todo:
        cls = todo.pop()
        for sub in cls.__subclasses__():
            if sub not in out:
                out.append(sub)
                todo.append(sub)
    return sorted(out, key=lambda c: c.__name__)


def _overrides(cls: type, base: type, name: str) -> bool:
    return getattr(cls, name, None) is not getattr(base, name, None)


class _Location:
    """Map a class back to (SourceFile, line) for pragma suppression."""

    def __init__(self, project: Project):
        self._project = project

    def of(self, cls: type):
        try:
            path = inspect.getsourcefile(cls)
            line = inspect.getsourcelines(cls)[1]
        except (OSError, TypeError):
            return None, 0
        if path is None:
            return None, 0
        marker = f"/{self._project.package}/"
        pos = path.rfind(marker)
        if pos < 0:
            return None, line
        return self._project.source(path[pos + len(marker):]), line


@register_pass
class RegistryConformance(AnalysisPass):
    name = "registry-conformance"
    description = ("backends implement the full ClusterIndex protocol "
                   "with consistent capability flags")

    #: injectable for fixture tests: explicit class list + base class,
    #: and the factories by backend name
    def __init__(self, classes: Optional[Iterable[type]] = None,
                 base: Optional[type] = None,
                 factories: Optional[Dict[str, Callable]] = None):
        super().__init__()
        self._classes = None if classes is None else list(classes)
        self._base = base
        self._factories = factories

    def run(self, project: Project) -> List[Finding]:
        base = self._base
        classes = self._classes
        if base is None or classes is None:
            from .. import api  # noqa: F401 — registers the backends
            from .. import shard  # noqa: F401 — registers "sharded"
            from .. import tiered  # noqa: F401 — TieredIndex too
            from ..api.index import ClusterIndex

            base = base or ClusterIndex
            if classes is None:
                classes = _subclass_closure(ClusterIndex)
        loc = _Location(project)
        for cls in classes:
            self._check_class(cls, base, *loc.of(cls))
        self._check_factories(loc)
        return self.findings

    # ------------------------------------------------------------------ #
    def _check_class(self, cls: type, base: type,
                     sf: Optional[SourceFile], line: int) -> None:
        name = cls.__name__
        abstract = sorted(getattr(cls, "__abstractmethods__", ()))
        if abstract and not name.startswith("_"):
            self.emit(sf, line, "REG001",
                      f"{name} leaves abstract methods unimplemented: "
                      f"{', '.join(abstract)}", path=sf.rel if sf else name)
            return
        for a, b in (("_state", "_load_state"), ("snapshot", "restore")):
            if _overrides(cls, base, a) != _overrides(cls, base, b):
                self.emit(sf, line, "REG002",
                          f"{name} overrides {a!r} and {b!r} asymmetrically "
                          "— snapshots that cannot round-trip",
                          path=sf.rel if sf else name)
        flag = bool(cls.__dict__.get("native_component_queries", False))
        has_anchor = _overrides(cls, base, "core_anchor_of")
        if flag and not has_anchor:
            self.emit(sf, line, "REG003",
                      f"{name} advertises native_component_queries but "
                      "inherits the raising core_anchor_of",
                      path=sf.rel if sf else name)
        elif has_anchor and not flag and not self._declares_flag(cls):
            self.emit(sf, line, "REG004",
                      f"{name} implements core_anchor_of but never "
                      "declares native_component_queries — the sharded "
                      "merge will not use it", path=sf.rel if sf else name)

    @staticmethod
    def _declares_flag(cls: type) -> bool:
        """Instance-level capability declaration (e.g. ShardedIndex sets
        the flag per transport handshake in __init__)."""
        try:
            src = inspect.getsource(cls)
        except (OSError, TypeError):
            return False
        return "native_component_queries" in src

    def _check_factories(self, loc: _Location) -> None:
        factories = self._factories
        if factories is None:
            if self._classes is not None:
                return  # fixture mode: no live registry to inspect
            from ..api import registry as reg

            factories = {name: reg._REGISTRY[name]
                         for name in reg.available_backends()}
        for name, factory in sorted(factories.items()):
            try:
                sig = inspect.signature(factory)
            except (TypeError, ValueError):  # pragma: no cover
                continue
            required = [p for p in sig.parameters.values()
                        if p.default is p.empty
                        and p.kind in (p.POSITIONAL_ONLY,
                                       p.POSITIONAL_OR_KEYWORD)]
            if len(required) != FACTORY_PARAMS:
                sf, line = loc.of(factory)  # type: ignore[arg-type]
                self.emit(sf, line, "REG005",
                          f"backend factory {name!r} must take exactly two "
                          "required parameters (the ClusterConfig and the "
                          "device, Optional[str]), got "
                          f"{len(required)}")
