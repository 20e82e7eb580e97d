"""The JAX package's parameter tree -> the port's.

``repro.models.transformer.init_lm`` stacks the layers along a leading
``n_layers`` axis (``repro/models/layers.py`` ``stack_layers``); the port
keeps a list of per-layer dicts.  Given the reference's tree as numpy
arrays (``jax.tree.map(np.asarray, params)``), :func:`params_from_jax`
slices it per layer and moves it to ``device`` in the same dtypes, so
both packages compute the same model.  Only the tests need this: the
port's own ``init`` draws its weights from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs import unported_family


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def _tree(node, device, layer=None):
    if isinstance(node, dict):
        return {k: _tree(v, device, layer) for k, v in node.items()}
    return _tensor(node if layer is None else np.asarray(node)[layer],
                   device)


def params_from_jax(np_params: Dict[str, Any], cfg,
                    device="cpu") -> Dict[str, Any]:
    if cfg.family != "dense":
        raise unported_family(cfg.family)
    out = {k: _tree(v, device) for k, v in np_params.items()
           if k != "layers"}
    stacked = np_params["layers"]
    n = np.asarray(stacked["ln_attn"]["w"]).shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"the tree has {n} layers, cfg {cfg.n_layers}")
    out["layers"] = [_tree(stacked, device, i) for i in range(n)]
    return out
