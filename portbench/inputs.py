"""The benchmark's inputs, made from ``--seed``: the token stream with its
example embeddings, and the model's weights.

``TokenStream`` is a frozen copy of the arithmetic of the port's
``SyntheticTokenStream`` (documents of 16 topics: a topic's token bias
plus a uniform draw of 100, an embedding at the topic's centre plus
noise), so that the traffic stays what it is when the program changes.

The weights are one flat float32 buffer drawn on the device in chunks
of ``CHUNK`` values, each chunk from a generator of its own seeded from
``(seed, chunk)``, then cut into leaves in the layout the port's models
read (``embed``, ``layers[i]`` with ``attn`` / ``ln_attn`` / ``mlp`` or
``moe`` / ``ln_mlp``, ``ln_f``, ``head``) and scaled by each leaf's
init std (norm scales are zeros: the models scale by ``1 + w``).  The
draw is the same for the program and for the reference, and a leaf's
starting value can be drawn again alone (:func:`initial_leaf_norms`).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

#: values drawn by one generator call
CHUNK = 1 << 26


class TokenStream:
    """Endless fixed-shape batches: ``tokens``, ``labels`` (the tokens
    shifted by one, wrapping), ``embeddings`` (batch, embed_dim) f32 and
    ``topics``."""

    def __init__(self, vocab: int, seq: int, batch: int, seed: int,
                 n_topics: int = 16, embed_dim: int = 16):
        self.vocab, self.seq, self.batch = vocab, seq, batch
        self.rng = np.random.default_rng(seed)
        self.n_topics, self.embed_dim = n_topics, embed_dim
        self.centers = self.rng.normal(size=(n_topics, embed_dim))
        self.bias = self.rng.integers(0, max(vocab - 100, 1), size=n_topics)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            topics = self.rng.integers(0, self.n_topics, size=self.batch)
            toks = (self.bias[topics][:, None] + self.rng.integers(
                0, 100, size=(self.batch, self.seq))) % self.vocab
            emb = self.centers[topics] + 0.1 * self.rng.normal(
                size=(self.batch, self.embed_dim))
            yield {"tokens": toks.astype(np.int32),
                   "labels": np.roll(toks, -1, axis=1).astype(np.int32),
                   "embeddings": emb.astype(np.float32),
                   "topics": topics}


def padded_vocab(vocab: int) -> int:
    return -(-vocab // 256) * 256


def layout(arch: Dict[str, Any]) -> List[Tuple[Tuple, Tuple[int, ...], float]]:
    """(path, shape, std) of every leaf in draw order; std 0: zeros."""
    E, V = arch["d_model"], padded_vocab(arch["vocab_size"])
    Hq, Hkv = arch["n_heads"], arch["n_kv_heads"]
    Dh = arch.get("head_dim") or E // Hq
    F, X = arch["d_ff"], arch.get("n_experts", 0)
    out = [(("embed", "table"), (V, E), 1.0)]
    for i in range(arch["n_layers"]):
        lay = ("layers", i)
        out += [
            (lay + ("attn", "wq"), (E, Hq, Dh), E ** -0.5),
            (lay + ("attn", "wk"), (E, Hkv, Dh), E ** -0.5),
            (lay + ("attn", "wv"), (E, Hkv, Dh), E ** -0.5),
            (lay + ("attn", "wo"), (Hq, Dh, E), (Hq * Dh) ** -0.5),
            (lay + ("ln_attn", "w"), (E,), 0.0),
        ]
        if arch["family"] == "moe":
            out += [
                (lay + ("moe", "router"), (E, X), E ** -0.5),
                (lay + ("moe", "w_gate"), (X, E, F), E ** -0.5),
                (lay + ("moe", "w_up"), (X, E, F), E ** -0.5),
                (lay + ("moe", "w_down"), (X, F, E), F ** -0.5),
            ]
        elif arch["family"] == "dense":
            out += [
                (lay + ("mlp", "w_gate"), (E, F), E ** -0.5),
                (lay + ("mlp", "w_up"), (E, F), E ** -0.5),
                (lay + ("mlp", "w_down"), (F, E), F ** -0.5),
            ]
        else:
            raise ValueError(f"family {arch['family']!r} has no layout here")
        out.append((lay + ("ln_mlp", "w"), (E,), 0.0))
    out += [(("ln_f", "w"), (E,), 0.0), (("head", "w"), (E, V), E ** -0.5)]
    return out


def _numel(shape) -> int:
    return int(np.prod(shape)) if shape else 1


def _generator(seed: int, chunk: int, device) -> torch.Generator:
    mixed = (int(seed) * 1_000_003 + chunk * 7_919 + 12_345) % (2**63 - 1)
    return torch.Generator(device=device).manual_seed(mixed)


def _chunk(seed: int, c: int, total: int, device) -> torch.Tensor:
    n = min(CHUNK, total - c * CHUNK)
    return torch.randn(n, generator=_generator(seed, c, device),
                       dtype=torch.float32, device=device)


def _skeleton(arch: Dict[str, Any]) -> Dict[str, Any]:
    return {"embed": {}, "layers": [{} for _ in range(arch["n_layers"])],
            "ln_f": {}, "head": {}}


def _place(tree, path, value) -> None:
    node = tree
    for key in path[:-2]:
        node = node[key]
    node.setdefault(path[-2], {})[path[-1]] = value


def make_params(arch: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The weights of ``arch`` from ``seed``, float32 on ``device``, as
    views into one buffer."""
    lay = layout(arch)
    total = sum(_numel(s) for _, s, _ in lay)
    buf = torch.empty(total, dtype=torch.float32, device=device)
    for c in range(-(-total // CHUNK)):
        draw = _chunk(seed, c, total, device)
        buf[c * CHUNK:c * CHUNK + draw.numel()].copy_(draw)
        del draw
    tree = _skeleton(arch)
    off = 0
    for path, shape, std in lay:
        n = _numel(shape)
        leaf = buf[off:off + n].view(shape)
        if std == 0.0:
            leaf.zero_()
        else:
            leaf.mul_(std)
        _place(tree, path, leaf)
        off += n
    return tree


def leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def leaf_name(path) -> str:
    return ".".join(str(k) for k in path)


@torch.no_grad()
def initial_leaf_norms(arch: Dict[str, Any], seed: int, tree,
                       device) -> Dict[str, float]:
    """``||tree leaf - its starting value||`` for every leaf, the
    starting values drawn again one chunk at a time (the f32 norm of the
    difference, summed over the chunks a leaf spans)."""
    lay = layout(arch)
    total = sum(_numel(s) for _, s, _ in lay)
    sq = {leaf_name(p): torch.zeros((), dtype=torch.float64, device=device)
          for p, _, _ in lay}
    spans = []
    off = 0
    for path, shape, std in lay:
        n = _numel(shape)
        spans.append((path, off, off + n, std))
        off += n
    for c in range(-(-total // CHUNK)):
        lo, hi = c * CHUNK, min((c + 1) * CHUNK, total)
        draw = None
        for path, a, b, std in spans:
            if b <= lo or a >= hi:
                continue
            s, e = max(a, lo), min(b, hi)
            now = leaf(tree, path).reshape(-1)[s - a:e - a].float()
            if std == 0.0:
                d = now
            else:
                if draw is None:
                    draw = _chunk(seed, c, total, device)
                d = now - draw[s - lo:e - lo] * std
            sq[leaf_name(path)] += torch.sum(d * d).double()
    return {k: float(torch.sqrt(v)) for k, v in sq.items()}


def leaf_norms(tree, arch: Dict[str, Any]) -> Dict[str, float]:
    """``||leaf||`` (in f32) of every leaf of ``tree``."""
    with torch.no_grad():
        out = {leaf_name(path): torch.linalg.vector_norm(
            leaf(tree, path).float()) for path, _, _ in layout(arch)}
    return {k: float(v) for k, v in out.items()}
