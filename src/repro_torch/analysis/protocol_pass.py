"""protocol-exhaustiveness — the wire protocol has no unwired message.

The ``repro_torch.service`` protocol's correctness rests on three
conventions that nothing at runtime checks until a frame actually
crosses the wire:

  * every message class is codec-registered (an unregistered class
    encodes fine locally and explodes as ``unknown message kind`` on the
    *peer* — a version-skew landmine);
  * every ``*Req`` has a dispatch handler in ``ClusterService`` and a
    resolvable response type (the dedicated ``*Resp`` when one exists);
  * every numpy payload field declares its wire dtype (``_dtypes`` /
    ``_poly_dtypes`` / ``_array_dicts``) and none of them is ``object``
    — object arrays require pickling, which the codec (rightly) refuses.

This pass verifies all three by *importing* the messages module (the
registry and dataclass fields are runtime facts) and walking the service
module's AST for the ``_dispatch`` table (handler wiring is a source
fact).  Findings anchor to the class definition lines in the messages
source so suppression pragmas work per class.

Rules:
  PROTO001  message class not codec-registered
  PROTO002  ndarray payload field with no declared wire dtype
  PROTO003  declared wire dtype is not fixed-size (object/void)
  PROTO004  *Req class with no ClusterService dispatch handler
  PROTO005  dispatch handler with no resolvable *Resp return type
  PROTO006  handler bypasses the dedicated *Resp paired with its *Req

A copy of ``repro.analysis.protocol_pass`` over the port's own protocol:
it imports ``repro_torch.service.messages`` and reads
``repro_torch/service/service.py``'s ``ClusterService._dispatch``; the
rules and messages are the reference's.
"""

from __future__ import annotations

import ast
import dataclasses
from types import ModuleType
from typing import Dict, List, Optional, Tuple

import numpy as np

from .base import AnalysisPass, register_pass
from .findings import Finding
from .walker import Project, SourceFile

#: generic response classes a *Req may resolve to when it has no
#: dedicated ``*Resp`` (acks and opaque-value queries)
GENERIC_RESPONSES = ("OkResp", "ValueResp", "ValuesResp", "ErrorResp")


def _message_classes(mod: ModuleType) -> Dict[str, type]:
    """Concrete message dataclasses defined in ``mod`` (kind != "")."""
    out = {}
    for name, obj in vars(mod).items():
        if (isinstance(obj, type) and dataclasses.is_dataclass(obj)
                and getattr(obj, "kind", "") and obj.__module__ == mod.__name__):
            out[name] = obj
    return out


def _class_lines(sf: Optional[SourceFile]) -> Dict[str, int]:
    if sf is None:
        return {}
    return {node.name: node.lineno for node in ast.walk(sf.tree)
            if isinstance(node, ast.ClassDef)}


class _DispatchTable:
    """The ``self._dispatch = {...}`` table of a service module, plus the
    return annotation (or constructed response) of each handler."""

    def __init__(self, sf: SourceFile, class_name: str = "ClusterService"):
        self.sf = sf
        self.entries: Dict[str, Tuple[int, Optional[str]]] = {}
        cls = next((n for n in ast.walk(sf.tree)
                    if isinstance(n, ast.ClassDef) and n.name == class_name),
                   None)
        if cls is None:
            return
        methods = {n.name: n for n in cls.body
                   if isinstance(n, ast.FunctionDef)}
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
            elif isinstance(node, ast.AnnAssign):
                t = node.target
            else:
                continue
            if not (isinstance(t, ast.Attribute) and t.attr == "_dispatch"
                    and isinstance(node.value, ast.Dict)):
                continue
            for key, val in zip(node.value.keys, node.value.values):
                req = self._req_name(key)
                if req is None:
                    continue
                self.entries[req] = (key.lineno, self._resp_name(val, methods))

    @staticmethod
    def _req_name(key: Optional[ast.expr]) -> Optional[str]:
        if isinstance(key, ast.Attribute):
            return key.attr
        if isinstance(key, ast.Name):
            return key.id
        return None

    def _resp_name(self, val: ast.expr,
                   methods: Dict[str, ast.FunctionDef]) -> Optional[str]:
        """Response class a dispatch value produces: the bound method's
        return annotation, or the ``*Resp(...)`` call a lambda returns."""
        if isinstance(val, ast.Attribute):  # self._handler
            fn = methods.get(val.attr)
            if fn is not None and fn.returns is not None:
                return self._ann_name(fn.returns)
            return None
        if isinstance(val, ast.Lambda):
            for sub in ast.walk(val.body):
                if isinstance(sub, ast.Call):
                    name = self._ann_name(sub.func)
                    if name and name.endswith("Resp"):
                        return name
        return None

    @staticmethod
    def _ann_name(node: ast.expr) -> Optional[str]:
        if isinstance(node, ast.Attribute):
            return node.attr
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value.rsplit(".", 1)[-1]
        return None


@register_pass
class ProtocolExhaustiveness(AnalysisPass):
    name = "protocol-exhaustiveness"
    description = ("every wire message is codec-registered, dispatched, "
                   "and fixed-dtype")

    #: messages module + source/service-source locations, overridable so
    #: fixture tests can analyse a synthetic protocol
    def __init__(self, messages: Optional[ModuleType] = None,
                 messages_rel: str = "service/messages.py",
                 service_rel: str = "service/service.py",
                 service_class: str = "ClusterService"):
        super().__init__()
        self._messages = messages
        self._messages_rel = messages_rel
        self._service_rel = service_rel
        self._service_class = service_class

    def run(self, project: Project) -> List[Finding]:
        mod = self._messages
        if mod is None:
            from ..service import messages as mod  # type: ignore[no-redef]
        classes = _message_classes(mod)
        registered = set(getattr(mod, "MESSAGE_TYPES", {}).values())
        msf = project.source(self._messages_rel)
        lines = _class_lines(msf)
        ssf = project.source(self._service_rel)
        table = _DispatchTable(ssf, self._service_class) if ssf else None

        for name, cls in sorted(classes.items()):
            line = lines.get(name, 0)
            if cls not in registered:
                self.emit(msf, line, "PROTO001",
                          f"message class {name} (kind={cls.kind!r}) is not "
                          "codec-registered — a peer cannot decode it")
            self._check_dtypes(msf, line, name, cls)
            if name.endswith("Req") and table is not None:
                self._check_dispatch(msf, line, name, classes, table)
        return self.findings

    # ------------------------------------------------------------------ #
    def _check_dtypes(self, msf: Optional[SourceFile], line: int,
                      name: str, cls: type) -> None:
        dtypes = getattr(cls, "_dtypes", {})
        poly = getattr(cls, "_poly_dtypes", {})
        array_dicts = getattr(cls, "_array_dicts", ())
        declared = set(dtypes) | set(poly) | set(array_dicts)
        for f in dataclasses.fields(cls):
            if "ndarray" not in str(f.type):
                continue
            if f.name not in declared:
                self.emit(msf, line, "PROTO002",
                          f"{name}.{f.name} is a numpy payload with no "
                          "declared wire dtype (_dtypes/_poly_dtypes/"
                          "_array_dicts)")
        flat = list(dtypes.items())
        flat += [(k, d) for k, ds in poly.items() for d in ds]
        for field_name, dt in flat:
            kind = np.dtype(dt).kind
            if kind in ("O", "V"):
                self.emit(msf, line, "PROTO003",
                          f"{name}.{field_name} declares non-fixed dtype "
                          f"{np.dtype(dt)!r} — object arrays cannot cross "
                          "the wire unpickled")

    def _check_dispatch(self, msf: Optional[SourceFile], line: int,
                        name: str, classes: Dict[str, type],
                        table: _DispatchTable) -> None:
        entry = table.entries.get(name)
        if entry is None:
            self.emit(msf, line, "PROTO004",
                      f"{name} has no {self._service_class}._dispatch "
                      "handler — the request is a guaranteed wire error")
            return
        dline, resp = entry
        dedicated = name[:-len("Req")] + "Resp"
        if resp is None:
            self.emit(table.sf, dline, "PROTO005",
                      f"dispatch handler for {name} has no resolvable "
                      "*Resp return type")
        elif dedicated in classes and resp != dedicated:
            self.emit(table.sf, dline, "PROTO006",
                      f"dispatch handler for {name} returns {resp}, "
                      f"bypassing its dedicated {dedicated}")
        elif dedicated not in classes and resp not in classes and \
                resp not in GENERIC_RESPONSES:
            self.emit(table.sf, dline, "PROTO005",
                      f"dispatch handler for {name} returns unknown "
                      f"response type {resp}")
