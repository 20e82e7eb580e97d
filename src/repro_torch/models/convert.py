"""The JAX package's parameter tree -> the port's.

``repro.models`` stacks each layer stack along a leading axis
(``repro/models/layers.py`` ``stack_layers``): ``layers`` for the
decoder-only families, ``enc_layers`` and ``dec_layers`` for the
encoder-decoder; the port keeps a list of per-layer dicts.  Given the
reference's tree as numpy arrays (``jax.tree.map(np.asarray, params)``),
:func:`params_from_jax` slices each stack per layer (a moe layer's
experts stay stacked: (X, E, F)) and moves every leaf to ``device`` in
the same dtype, so both packages compute the same model: the ssm
subtree, hybrid's ``comb``, a vlm's ``vision_proj`` and whisper's
``frontend`` / ``ln_enc`` come across as they are.  With ``mesh=`` the
tree is then placed on the mesh by the port's logical axes
(``registry.shard_params``), so both packages compute the same function
on the same mesh.  Only the tests need this: the port's own ``init``
draws its weights from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def _tree(node, device, layer=None):
    if isinstance(node, dict):
        return {k: _tree(v, device, layer) for k, v in node.items()}
    return _tensor(node if layer is None else np.asarray(node)[layer],
                   device)


def _first_leaf(node):
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return np.asarray(node)


def params_from_jax(np_params: Dict[str, Any], cfg, device="cpu",
                    mesh=None) -> Dict[str, Any]:
    stacks = {"layers": cfg.n_layers, "dec_layers": cfg.n_layers,
              "enc_layers": cfg.n_encoder_layers}
    out = {}
    for name, node in np_params.items():
        if name not in stacks:
            out[name] = _tree(node, device)
            continue
        n = _first_leaf(node).shape[0]
        if n != stacks[name]:
            raise ValueError(f"the tree's {name} has {n} layers, cfg "
                             f"{stacks[name]}")
        out[name] = [_tree(node, device, i) for i in range(n)]
    if mesh is None:
        return out
    from .registry import build_model, shard_params

    return shard_params(out, build_model(cfg, device=device).axes(), mesh)
