"""Port vs reference: the graph sampler (``data/graph_sampler.py``).

The port is a numpy copy with one addition, ``device=``, which runs the
CSR build's stable sort of ``dst`` as ``torch.sort(stable=True)``.
Every result is held bit for bit against the reference for the same
seeds (``tests/test_train_runtime.py::test_graph_sampler`` is the
oracle's call): ``CSRGraph.from_edges`` on both sort routes,
``random_graph`` and ``sample_subgraph`` with its padding, whose pad
edges are self-loops on the last real node (the reference's quirk).
"""
import numpy as np
import pytest

from repro.data import graph_sampler as J
from repro_torch.data import graph_sampler as T

ROUTES = (None, "cpu")          # numpy, torch.sort


def _equal_csr(got, want):
    assert got.n_nodes == want.n_nodes
    for f in ("indptr", "indices"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _equal_sample(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("route", ROUTES, ids=["numpy", "torch"])
@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_from_edges_matches_reference(route, dtype):
    """Duplicate edges, isolated nodes (the last ones too) and many ties
    in ``dst``: the stable order keeps each node's neighbours in input
    order."""
    rng = np.random.default_rng(5)
    n = 40
    src = rng.integers(0, n, 600).astype(dtype)
    dst = rng.integers(0, n - 5, 600).astype(dtype)
    dst[::7] = 3
    _equal_csr(T.CSRGraph.from_edges(src, dst, n, device=route),
               J.CSRGraph.from_edges(src, dst, n))
    empty = np.zeros(0, dtype)
    _equal_csr(T.CSRGraph.from_edges(empty, empty, 4, device=route),
               J.CSRGraph.from_edges(empty, empty, 4))


@pytest.mark.parametrize("route", ROUTES, ids=["numpy", "torch"])
def test_from_edges_refuses_ids_outside_the_nodes(route):
    src = np.zeros(3, np.int64)
    for bad in (10, -1):
        dst = np.array([0, bad, 1])
        with pytest.raises(ValueError):
            J.CSRGraph.from_edges(src, dst, 10)
        with pytest.raises(ValueError):
            T.CSRGraph.from_edges(src, dst, 10, device=route)


@pytest.mark.parametrize("route", ROUTES, ids=["numpy", "torch"])
@pytest.mark.parametrize("n,deg,seed", [(1000, 8, 0), (257, 3, 11)])
def test_random_graph_matches_reference(route, n, deg, seed):
    g = T.random_graph(n, avg_degree=deg, seed=seed, device=route)
    _equal_csr(g, J.random_graph(n, avg_degree=deg, seed=seed))
    v = int(np.argmax(np.diff(g.indptr)))
    np.testing.assert_array_equal(
        g.neighbors(v), J.random_graph(n, deg, seed).neighbors(v))


@pytest.mark.parametrize("fanouts,pads", [
    ((5, 3), (800, 800)),       # the reference test's call
    ((5, 3), (0, 0)),           # unpadded
    ((4, 2, 2), (2000, 3000)),  # three hops
])
def test_sample_subgraph_matches_reference(fanouts, pads):
    gj = J.random_graph(1000, avg_degree=8, seed=0)
    gt = T.random_graph(1000, avg_degree=8, seed=0, device="cpu")
    rj, rt = np.random.default_rng(0), np.random.default_rng(0)
    seeds = rj.choice(1000, 32, replace=False)
    assert np.array_equal(seeds, rt.choice(1000, 32, replace=False))
    want = J.sample_subgraph(gj, seeds, fanouts, rj, pad_nodes=pads[0],
                             pad_edges=pads[1])
    got = T.sample_subgraph(gt, seeds, fanouts, rt, pad_nodes=pads[0],
                            pad_edges=pads[1])
    _equal_sample(got, want)
    # the two generators stayed in step
    assert rt.integers(1 << 30) == rj.integers(1 << 30)
    ne, nn = got["n_edges"], got["n_nodes"]
    assert (got["dst"][:ne] < nn).all() and (got["src"][:ne] < nn).all()
    if pads[1] > ne:        # pad edges: self-loops on a real node
        assert (got["src"][ne:] == nn - 1).all()
        assert (got["dst"][ne:] == nn - 1).all()
    assert (got["node_ids"][nn:] == -1).all()


def test_sample_subgraph_with_isolated_seeds():
    """Seeds without in-edges add no edges; an empty seed set pads onto
    node 0."""
    src, dst = np.array([1, 2, 3, 0]), np.array([0, 0, 1, 2])
    gj = J.CSRGraph.from_edges(src, dst, 6)
    gt = T.CSRGraph.from_edges(src, dst, 6, device="cpu")
    for seeds in (np.array([4, 5, 0]), np.array([], np.int64)):
        want = J.sample_subgraph(gj, seeds, (2, 2),
                                 np.random.default_rng(1), 8, 8)
        got = T.sample_subgraph(gt, seeds, (2, 2),
                                np.random.default_rng(1), 8, 8)
        _equal_sample(got, want)
