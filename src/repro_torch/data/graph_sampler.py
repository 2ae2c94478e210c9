"""Neighbor sampler for minibatch GNN training (a numpy copy of the
reference's ``data/graph_sampler.py``).

Builds a CSR adjacency once, then draws GraphSAGE-style fixed-fanout
k-hop samples.  Output is a padded subgraph (locally re-indexed) ready for
``repro_torch.models.schnet``.  ``device=`` runs the CSR build's stable
sort of ``dst`` as ``torch.sort(stable=True)`` on that device (a
Reddit-scale graph's 114.6M edges take tens of seconds in numpy); the
result is numpy either way, and the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray   # int64[N+1]
    indices: np.ndarray  # int32[E]
    n_nodes: int

    @staticmethod
    def from_edges(src, dst, n_nodes: int, device=None) -> "CSRGraph":
        if device is None:
            order = np.argsort(dst, kind="stable")
            src_s = np.asarray(src)[order].astype(np.int32)
            dst_s = np.asarray(dst)[order]
            counts = np.bincount(dst_s, minlength=n_nodes)
            indptr = np.zeros(n_nodes + 1, np.int64)
            indptr[1:] = np.cumsum(counts)
            return CSRGraph(indptr=indptr, indices=src_s, n_nodes=n_nodes)
        dst_s, order = torch.sort(torch.from_numpy(np.asarray(dst)).to(device),
                                  stable=True)
        # numpy's bincount refuses a negative id and its cumsum one >= N
        if len(dst_s) and (int(dst_s[0]) < 0 or int(dst_s[-1]) >= n_nodes):
            raise ValueError(f"dst ids outside [0, {n_nodes})")
        src_s = torch.from_numpy(np.asarray(src)).to(device).to(
            torch.int32)[order]
        del order
        # indptr[v] = #edges with dst < v
        indptr = torch.searchsorted(dst_s, torch.arange(
            n_nodes + 1, dtype=dst_s.dtype, device=device))
        return CSRGraph(indptr=indptr.cpu().numpy(),
                        indices=src_s.cpu().numpy(), n_nodes=n_nodes)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]: self.indptr[v + 1]]


def sample_subgraph(g: CSRGraph, seeds: np.ndarray,
                    fanouts: Tuple[int, ...], rng: np.random.Generator,
                    pad_nodes: int = 0, pad_edges: int = 0):
    """Fixed-fanout k-hop sampling (GraphSAGE).

    Returns dict(node_ids, src, dst, n_nodes, n_edges) where src/dst are
    LOCAL indices; edges point hop-(k+1) -> hop-k (message flow toward the
    seeds).  Arrays are padded to (pad_nodes, pad_edges) when given: pad
    edges are self-loops on node ``n_nodes - 1``, a real node (the
    reference's quirk, kept: ROADMAP.md's reproduced quirks).
    """
    node_ids: List[int] = list(seeds)
    local = {int(v): i for i, v in enumerate(seeds)}
    srcs: List[int] = []
    dsts: List[int] = []
    frontier = list(seeds)
    for fan in fanouts:
        nxt = []
        for v in frontier:
            nb = g.neighbors(int(v))
            if len(nb) == 0:
                continue
            pick = rng.choice(nb, size=min(fan, len(nb)), replace=False)
            for u in pick:
                u = int(u)
                if u not in local:
                    local[u] = len(node_ids)
                    node_ids.append(u)
                    nxt.append(u)
                srcs.append(local[u])
                dsts.append(local[int(v)])
        frontier = nxt
    n_nodes, n_edges = len(node_ids), len(srcs)
    pn = max(pad_nodes, n_nodes)
    pe = max(pad_edges, n_edges)
    out_nodes = np.full(pn, -1, np.int64)
    out_nodes[:n_nodes] = node_ids
    src = np.zeros(pe, np.int32)
    dst = np.zeros(pe, np.int32)
    src[:n_edges] = srcs
    dst[:n_edges] = dsts
    if n_edges < pe:       # pad edges as self-loops on a dummy node
        src[n_edges:] = n_nodes - 1 if n_nodes else 0
        dst[n_edges:] = n_nodes - 1 if n_nodes else 0
    return dict(node_ids=out_nodes, src=src, dst=dst,
                n_nodes=n_nodes, n_edges=n_edges)


def random_graph(n_nodes: int, avg_degree: int, seed: int = 0,
                 device=None) -> CSRGraph:
    """Uniform random edges (``n_nodes * avg_degree``) from ``seed``;
    ``device``: where :meth:`CSRGraph.from_edges` sorts."""
    rng = np.random.default_rng(seed)
    e = n_nodes * avg_degree
    src = rng.integers(0, n_nodes, e)
    dst = rng.integers(0, n_nodes, e)
    return CSRGraph.from_edges(src, dst, n_nodes, device)
