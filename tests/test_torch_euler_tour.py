"""The port's sequence structures and Euler-tour forest against the JAX
package's (``repro.core.skiplist`` / ``treap_seq`` / ``euler_tour`` /
``buckets``, all pure Python).

Both sides take the same seeds and the same operations; every answer
must be identical, tolerance zero: return values of ``link`` / ``cut``,
the ``root()`` payload of every node (the sequence head, which depends
on the towers or priorities each side drew from ``random.Random``),
``connected``, each tree's tour order, ``degree``, the edge set and the
``n_links`` / ``n_cuts`` counters.  The random link/cut sequences are
those of ``tests/test_euler_tour.py``.
"""

import random

import pytest

pytest.importorskip("torch")

from repro.core import buckets as jax_buckets  # noqa: E402
from repro.core.euler_tour import EulerTourForest as JaxForest  # noqa: E402
from repro.core.skiplist import SkipListSeq as JaxSkipList  # noqa: E402
from repro.core.treap_seq import TreapSeq as JaxTreap  # noqa: E402
from repro_torch.core import buckets  # noqa: E402
from repro_torch.core.euler_tour import EulerTourForest  # noqa: E402
from repro_torch.core.skiplist import SkipListSeq  # noqa: E402
from repro_torch.core.treap_seq import TreapSeq  # noqa: E402


def _tour(f, v):
    return [e.payload for e in f._sl.iter_seq(f._loop[v])]


def assert_same_forest(a, b, nodes):
    """Every query of the two forests gives the same answer."""
    nodes = list(nodes)
    assert [a.root(v) for v in nodes] == [b.root(v) for v in nodes]
    assert [_tour(a, v) for v in nodes] == [_tour(b, v) for v in nodes]
    assert [a.degree(v) for v in nodes] == [b.degree(v) for v in nodes]
    assert [sorted(a.neighbors(v)) for v in nodes] == \
        [sorted(b.neighbors(v)) for v in nodes]
    assert sorted(a._edge) == sorted(b._edge)
    assert (a.n_links, a.n_cuts, len(a)) == (b.n_links, b.n_cuts, len(b))
    for u in nodes[::3]:
        for v in nodes[1::4]:
            assert a.connected(u, v) == b.connected(u, v)
            assert a.has_edge(u, v) == b.has_edge(u, v)


@pytest.mark.parametrize("backend,seed", [("skiplist", s) for s in range(4)]
                         + [("treap", 0), ("treap", 5)])
def test_random_link_cut_matches_reference(backend, seed):
    """The link/cut stream of ``test_random_link_cut`` (60% links on the
    tree backend's test), with the edge-biased cuts."""
    rng = random.Random(seed)
    ours = EulerTourForest(seed=seed, backend=backend)
    ref = JaxForest(seed=seed, backend=backend)
    n = 40
    for v in range(n):
        ours.add_node(v)
        ref.add_node(v)
    edges = set()
    for step in range(600):
        op = rng.random()
        u, v = rng.randrange(n), rng.randrange(n)
        if u == v:
            continue
        if op < 0.55:
            got = ours.link(u, v)
            assert got == ref.link(u, v)
            if got:
                edges.add(frozenset((u, v)))
        else:
            if edges and rng.random() < 0.8:
                u, v = tuple(rng.choice(sorted(tuple(sorted(e))
                                               for e in edges)))
            assert ours.cut(u, v) == ref.cut(u, v)
            edges.discard(frozenset((u, v)))
        if step % 50 == 0:
            assert_same_forest(ours, ref, range(n))
    assert_same_forest(ours, ref, range(n))
    assert ours.n_links > 0 and ours.n_cuts > 0


@pytest.mark.parametrize("backend", ["skiplist", "treap"])
def test_tour_structure_and_node_removal_match_reference(backend):
    """``test_tour_structure_valid``'s stream, then every node is cut
    free and removed in turn, on both sides."""
    rng = random.Random(7)
    ours = EulerTourForest(seed=7, backend=backend)
    ref = JaxForest(seed=7, backend=backend)
    n = 25
    for v in range(n):
        ours.add_node(v)
        ref.add_node(v)
    for _ in range(200):
        u, v = rng.randrange(n), rng.randrange(n)
        if u == v:
            continue
        if rng.random() < 0.6:
            assert ours.link(u, v) == ref.link(u, v)
        else:
            assert ours.cut(u, v) == ref.cut(u, v)
    assert_same_forest(ours, ref, range(n))
    assert [sorted(ours.tree_nodes(v)) for v in range(n)] == \
        [sorted(ref.tree_nodes(v)) for v in range(n)]
    for v in range(n):
        for w in sorted(ours.neighbors(v)):
            assert ours.cut(v, w) and ref.cut(v, w)
        ours.remove_node(v)
        ref.remove_node(v)
        assert_same_forest(ours, ref, range(v + 1, n))
    ours.add_node(0)
    with pytest.raises(KeyError, match="already present"):
        ours.add_node(0)


@pytest.mark.parametrize("cls,ref_cls,seed",
                         [(SkipListSeq, JaxSkipList, s) for s in (0, 1, 2)]
                         + [(TreapSeq, JaxTreap, s) for s in (0, 3)])
def test_sequence_ops_match_reference(cls, ref_cls, seed):
    """Random concat / split_after over 60 elements: the same sequences,
    heads and tails (and, for the skip list, tower heights)."""
    rng = random.Random(100 + seed)
    ours, ref = cls(seed=seed), ref_cls(seed=seed)
    a = [ours.make_node(i) for i in range(60)]
    b = [ref.make_node(i) for i in range(60)]
    if cls is SkipListSeq:
        assert [x.height for x in a] == [x.height for x in b]
    for _ in range(400):
        i, j = rng.randrange(60), rng.randrange(60)
        if rng.random() < 0.5:
            same = ours.same_seq(a[i], a[j])
            assert same == ref.same_seq(b[i], b[j])
            if not same:
                ours.concat(a[i], a[j])
                ref.concat(b[i], b[j])
        else:
            ours.split_after(a[i])
            ref.split_after(b[i])
        for x, y in ((a[i], b[i]), (a[j], b[j])):
            assert [e.payload for e in ours.iter_seq(x)] == \
                [e.payload for e in ref.iter_seq(y)]
            assert ours.representative(x).payload == \
                ref.representative(y).payload
            assert ours.last(x).payload == ref.last(y).payload


def test_buckets_match_reference():
    """Core chains under random add / remove: the same (pred, succ)
    answers, first cores, sizes and bucket counts."""
    rng = random.Random(11)
    ours, ref = buckets.BucketIndex(3), jax_buckets.BucketIndex(3)
    for _ in range(1500):
        table, key = rng.randrange(3), bytes([rng.randrange(6)])
        idx = rng.randrange(50)
        bo, br = ours.get_or_create(table, key), ref.get_or_create(table,
                                                                   key)
        op = rng.random()
        if op < 0.35:
            bo.members.add(idx)
            br.members.add(idx)
            if idx not in bo.cores:
                bo.add_core(idx)
                br.add_core(idx)
        elif op < 0.7:
            bo.members.discard(idx)
            br.members.discard(idx)
            bo.remove_core(idx)
            br.remove_core(idx)
            ours.drop_if_empty(table, key)
            ref.drop_if_empty(table, key)
        assert bo.core_neighbors(idx) == br.core_neighbors(idx)
        assert bo.first_core() == br.first_core()
        assert (bo.cores, len(bo)) == (br.cores, len(br))
        assert ours.n_buckets() == ref.n_buckets()
    assert [sorted(t) for t in ours.tables] == [sorted(t) for t in ref.tables]
