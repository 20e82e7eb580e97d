"""Treap-backed sequence (Henzinger–King-style balanced-BST alternative to
the skip list) with the same split/concat/representative interface,
ported from ``repro.core.treap_seq`` (pure Python, unchanged).

The paper follows Tseng et al.'s skip lists; Henzinger & King's original
formulation used balanced binary trees — this backend exists to compare the
two (benchmarks) and as a drop-in for ``EulerTourForest`` via duck typing:
``representative`` here is the treap root (found by climbing parent
pointers, O(log n) expected).
"""

from __future__ import annotations

import random
from typing import Iterator, Optional


class TreapNode:
    __slots__ = ("left", "right", "parent", "prio", "payload")

    def __init__(self, prio: float, payload=None):
        self.left: Optional["TreapNode"] = None
        self.right: Optional["TreapNode"] = None
        self.parent: Optional["TreapNode"] = None
        self.prio = prio
        self.payload = payload


def _root(e: TreapNode) -> TreapNode:
    while e.parent is not None:
        e = e.parent
    return e


def _leftmost(t: Optional[TreapNode]) -> Optional[TreapNode]:
    if t is None:
        return None
    while t.left is not None:
        t = t.left
    return t


def _merge(a: Optional[TreapNode], b: Optional[TreapNode]) -> Optional[TreapNode]:
    if a is None:
        return b
    if b is None:
        return a
    if a.prio < b.prio:
        r = _merge(a.right, b)
        a.right = r
        if r is not None:
            r.parent = a
        a.parent = None
        return a
    r = _merge(a, b.left)
    b.left = r
    if r is not None:
        r.parent = b
    b.parent = None
    return b


def _detach(child: Optional[TreapNode]) -> Optional[TreapNode]:
    if child is not None:
        child.parent = None
    return child


def _split_after_node(e: TreapNode):
    """Split the treap containing e into ([..e], [e+1..]); returns roots."""
    # capture the ancestor path BEFORE any merge (merging can give e a new
    # parent inside the left piece)
    path = []
    cur = e
    while cur.parent is not None:
        p = cur.parent
        path.append((p, p.left is cur))
        cur.parent = None
        cur = p
    left = _detach(e.left)
    e.left = None
    rhs = _detach(e.right)
    e.right = None
    lhs = _merge(left, e)
    for p, came_left in path:
        if came_left:
            # p and p's right subtree come after e
            p.left = None
            rt = _detach(p.right)
            p.right = None
            rhs = _merge(rhs, _merge(p, rt))
        else:
            # p's left subtree and p come before e's piece
            p.right = None
            lt = _detach(p.left)
            p.left = None
            lhs = _merge(_merge(lt, p), lhs)
    return lhs, rhs


class TreapSeq:
    """Same interface as SkipListSeq (make_node + static ops)."""

    def __init__(self, seed: int = 0, **_):
        self._rng = random.Random(seed)

    def make_node(self, payload=None) -> TreapNode:
        return TreapNode(self._rng.random(), payload)

    @staticmethod
    def representative(e: TreapNode) -> TreapNode:
        return _root(e)

    @staticmethod
    def same_seq(a: TreapNode, b: TreapNode) -> bool:
        return _root(a) is _root(b)

    @staticmethod
    def first(e: TreapNode) -> TreapNode:
        return _leftmost(_root(e))

    @staticmethod
    def last(e: TreapNode) -> TreapNode:
        t = _root(e)
        while t.right is not None:
            t = t.right
        return t

    @staticmethod
    def iter_seq(e: TreapNode) -> Iterator[TreapNode]:
        stack = []
        node = _root(e)
        while stack or node is not None:
            while node is not None:
                stack.append(node)
                node = node.left
            node = stack.pop()
            yield node
            node = node.right

    @staticmethod
    def split_after(e: TreapNode) -> None:
        _split_after_node(e)

    @staticmethod
    def concat(a_any: TreapNode, b_any: TreapNode) -> None:
        _merge(_root(a_any), _root(b_any))
