"""String-keyed backend registry: ``ClusterConfig.backend`` -> factory.

Engines plug in with::

    @register_backend("my-engine")
    def _build(cfg: ClusterConfig, device: Optional[str]) -> ClusterIndex:
        return MyIndex(cfg, device)

and become constructible through ``build_index``.  Unlike ``repro.api``,
a factory also takes the device the index runs on (``None`` = the
backend's default), because the device is not a config field.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

from .config import ClusterConfig
from .index import ClusterIndex

Factory = Callable[[ClusterConfig, Optional[str]], ClusterIndex]

_REGISTRY: Dict[str, Factory] = {}

#: the built-in backends that run on a device (``device=None`` means
#: "cuda"); every other built-in backend runs on the host and refuses any
#: device but ``None`` and "cpu".  A caller that holds a device for its
#: own work (the serving engine) passes it only to these.
DEVICE_BACKENDS = ("batched-device", "soa-device")


def register_backend(name: str,
                     overwrite: bool = False) -> Callable[[Factory], Factory]:
    """Decorator registering a ``(cfg, device) -> ClusterIndex`` factory
    under ``name``.

    Re-registering an existing name raises unless ``overwrite=True``.
    """

    def deco(factory: Factory) -> Factory:
        if name in _REGISTRY and not overwrite:
            raise ValueError(
                f"backend {name!r} already registered "
                "(pass overwrite=True to replace it)"
            )
        _REGISTRY[name] = factory
        return factory

    return deco


def unregister_backend(name: str) -> None:
    """Remove ``name`` from the registry; raises KeyError if unknown."""
    try:
        del _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"backend {name!r} is not registered; "
            f"available: {', '.join(available_backends())}"
        ) from None


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def build_index(cfg: Union[ClusterConfig, str, None] = None, *,
                device: Optional[str] = None, **kwargs: Any) -> ClusterIndex:
    """Build a ClusterIndex from a config (or backend name + config kwargs).

    ``build_index(cfg)``, ``build_index("soa", d=8, k=10, t=10, eps=0.5)``
    and ``build_index(d=8, ..., backend="soa")`` are all accepted.
    ``device`` picks where a device backend (:data:`DEVICE_BACKENDS`:
    ``soa-device``, ``batched-device``) runs: "cuda" by default, "cpu"
    for its plain kernels; a host-only backend (``dynamic``, ``batched``,
    ``soa``, ``approx``, ``tiered``, ``emz-static``, ``naive``,
    ``emz-fixed``) accepts only ``None`` or "cpu" and raises on any
    other.
    """
    if isinstance(cfg, str):
        cfg = ClusterConfig(backend=cfg, **kwargs)
    elif cfg is None:
        cfg = ClusterConfig(**kwargs)
    elif kwargs:
        cfg = cfg.replace(**kwargs)
    try:
        factory = _REGISTRY[cfg.backend]
    except KeyError:
        raise KeyError(
            f"unknown backend {cfg.backend!r}; "
            f"available: {', '.join(available_backends())}"
        ) from None
    return factory(cfg, device)


def restore_index(snapshot: Dict[str, Any], *,
                  device: Optional[str] = None) -> ClusterIndex:
    """Rebuild a live index from a :meth:`ClusterIndex.snapshot` payload
    (one taken by this package or by ``repro.api``)."""
    cfg = ClusterConfig.from_dict(dict(snapshot["config"]))
    index = build_index(cfg, device=device)
    index.restore(snapshot)
    return index
