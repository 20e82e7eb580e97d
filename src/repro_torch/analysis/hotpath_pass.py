"""hot-path purity — no Python loops or host syncs where speed lives.

Two strictness tiers, matching how the repo splits its hot code:

**Device scope** — every function in ``repro_torch/kernels`` but its host
modules.  The kernels' bodies are CUDA (``kernels/csrc/*.cu``); the
Python there is what puts work on the card: the launch wrappers and the
plain PyTorch versions, which run on card tensors too (the gradient of
``flash_attention`` is the plain attention's).  Flagged:

  HOT001  Python ``for``/``while`` (each iteration is a host round of
          launches; on-device work is expressed as tensor ops or a
          kernel's grid)
  HOT002  host syncs: ``.item()``, ``.tolist()``, ``.cpu()``,
          ``.numpy()``, ``.synchronize()`` (``torch.cuda.synchronize()``
          and a stream's or an event's), and ``int(x)`` / ``float(x)`` /
          ``bool(x)`` of a non-literal value (each one, on a card
          tensor, stalls the host until the card has caught up)
  HOT003  host-numpy array construction (``np.asarray`` & co.)

**Interpreted hot scope** — any function carrying a ``# hot-path``
pragma (bridge resolution, the sharded ``label`` query, transport fast
paths).  Python loops are the idiom there, so only per-element
regressions are flagged:

  HOT101  numpy array construction inside a loop (``np.asarray`` & co.
          per element — the exact anti-pattern the vectorised batch
          paths exist to avoid)
  HOT102  ``.item()`` anywhere in the function
  HOT103  non-empty dict/list/set literal or comprehension allocated
          inside a loop (per-element container churn)

Suppress a deliberate exception with ``# analysis: allow[HOT001]`` on
(or directly above) the offending line, with its reason beside it.

A port of ``repro.analysis.hotpath_pass``.  The interpreted tier is the
reference's unchanged; the device scope differs, because in the
reference ``kernels/`` holds Pallas bodies and jitted wrappers, which
are traced, and here it holds host code that launches CUDA:

  * ``kernels/_build.py`` (the nvcc build, the library's load and the
    launch counters) and ``kernels/_checks.py`` (the argument checks
    before a launch) are host modules, out of device scope: they run on
    the host by design, the build once at first use;
  * HOT002 names PyTorch's syncs (``.tolist()``, ``.cpu()``,
    ``.numpy()``, ``.synchronize()``) beside the reference's ``.item()``,
    ``int()`` and ``float()``, and adds ``bool()`` (a tensor's truth is
    a sync in PyTorch as a traced value's is an error in JAX);
  * a conversion that is itself an argument of ``_build.launch(...)``
    is not flagged: the launch ABI passes host scalars (sizes, flags,
    the scale) by value, so they are host values by construction;
  * HOT003's message points at torch, not jnp.
"""

from __future__ import annotations

import ast
from typing import List, Set

from .base import AnalysisPass, register_pass
from .findings import Finding
from .walker import Project, SourceFile, enclosing

#: numpy constructors that materialise a fresh array on the host
_NP_ALLOC = ("asarray", "array", "ascontiguousarray", "stack", "fromiter",
             "frombuffer", "concatenate", "zeros", "ones", "empty", "full")

#: methods whose call waits for the card (or copies from it)
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy", "synchronize")

#: host conversions of a value: a sync when the value is a card tensor
_CONVERSIONS = ("int", "float", "bool")

#: modules under ``kernels/`` that run on the host by design
HOST_MODULES = ("kernels/_build.py", "kernels/_checks.py")


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _np_call(node: ast.Call) -> bool:
    f = node.func
    return (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
            and f.value.id in ("np", "numpy") and f.attr in _NP_ALLOC)


def _in_loop(node: ast.AST, fn: ast.FunctionDef) -> bool:
    loop = enclosing(node, ast.For, ast.While)
    return loop is not None and enclosing(loop, ast.FunctionDef) is fn


def _launch_args(fn: ast.FunctionDef) -> Set[int]:
    """Ids of the nodes that are arguments of a ``_build.launch(...)``
    call in ``fn``: the launch ABI's host scalars."""
    out: Set[int] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr == "launch"
                and isinstance(f.value, ast.Name) and f.value.id == "_build"):
            out.update(id(a) for a in node.args)
    return out


@register_pass
class HotPathPurity(AnalysisPass):
    name = "hot-path-purity"
    description = ("kernel wrappers stay vectorised and sync-free; "
                   "# hot-path functions stay free of per-element numpy "
                   "work")

    def __init__(self, device_prefix: str = "kernels/"):
        super().__init__()
        self._device_prefix = device_prefix

    def run(self, project: Project) -> List[Finding]:
        for sf in project.sources():
            device_file = (sf.rel.startswith(self._device_prefix)
                           and sf.rel not in HOST_MODULES)
            for fn in sf.functions():
                if device_file:
                    self._check_device(sf, fn)
                elif sf.is_hot_path(fn):
                    self._check_interpreted(sf, fn)
        return self.findings

    # ------------------------------------------------------------------ #
    def _check_device(self, sf: SourceFile, fn: ast.FunctionDef) -> None:
        where = f"device function {fn.name!r}"
        abi = _launch_args(fn)
        for node in ast.walk(fn):
            if isinstance(node, (ast.For, ast.While)):
                self.emit(sf, node.lineno, "HOT001",
                          f"Python loop in {where} — express as tensor ops "
                          "or a kernel grid dimension")
            elif isinstance(node, ast.Call):
                name = _call_name(node)
                if name in _SYNC_METHODS:
                    self.emit(sf, node.lineno, "HOT002",
                              f".{name}() in {where} forces a host sync")
                elif (name in _CONVERSIONS
                      and isinstance(node.func, ast.Name) and node.args
                      and not isinstance(node.args[0], ast.Constant)
                      and id(node) not in abi):
                    self.emit(sf, node.lineno, "HOT002",
                              f"{name}() of a non-literal in {where} "
                              "forces a host sync on a card tensor")
                elif _np_call(node):
                    self.emit(sf, node.lineno, "HOT003",
                              f"host-numpy call np.{node.func.attr} in "
                              f"{where} — use torch inside device code")

    def _check_interpreted(self, sf: SourceFile, fn: ast.FunctionDef) -> None:
        where = f"hot-path function {fn.name!r}"
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                if _np_call(node) and _in_loop(node, fn):
                    self.emit(sf, node.lineno, "HOT101",
                              f"per-element np.{node.func.attr} inside a "
                              f"loop in {where} — hoist to one batch pass")
                elif _call_name(node) == "item":
                    self.emit(sf, node.lineno, "HOT102",
                              f".item() in {where} forces a device sync "
                              "per element")
            elif (isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp))
                  and _in_loop(node, fn)):
                self.emit(sf, node.lineno, "HOT103",
                          f"comprehension allocated inside a loop in "
                          f"{where} — per-element container churn")
            elif isinstance(node, (ast.List, ast.Set, ast.Dict)):
                items = node.keys if isinstance(node, ast.Dict) else node.elts
                if items and _in_loop(node, fn):
                    self.emit(sf, node.lineno, "HOT103",
                              f"non-empty container literal inside a loop "
                              f"in {where} — per-element allocation")
