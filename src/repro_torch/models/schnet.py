"""SchNet (continuous-filter convolutions, arXiv:1706.08566) over plain
tensors (the reference's ``models/schnet.py``).

Message passing is an edge gather (``index_select``) and a scatter-add
to the destination nodes (``index_add_`` into zeros), both in the
compute dtype: the reference's ``jnp.take`` + ``jax.ops.segment_sum``.
Supports featureful graphs (node features projected into the hidden
space, per-edge "distances" from the input) and batched small molecules
(integer atom types, a per-graph readout).

Ids are in range: every ``src``, ``dst`` and ``atom_type`` in
``[0, N)``, every ``graph_id`` in ``[0, n_graphs)``, as the sampler
always emits them.  On the CPU an id out of range raises; the reference
fills NaN (``jnp.take``), drops the row (``segment_sum``) or clamps (the
atom table), and the port imitates none of it (ROADMAP.md Queue 3).
:func:`schnet_param_specs` gives the reference's logical specs (all
replicated: the scale axis is the edge stream, annotated ``edges`` in
the forward).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.dist.sharding import constrain
from repro_torch.models import layers as L

_LOG2 = math.log(2.0)


def ssp(x):
    """Shifted softplus (SchNet's activation): ``logaddexp(x, 0) - log
    2``, the reference's ``jax.nn.softplus`` (torch's ``softplus``
    returns x itself past its threshold of 20)."""
    return torch.logaddexp(x, x.new_zeros(())) - _LOG2


def rbf_centers(n_rbf: int, cutoff: float, device) -> torch.Tensor:
    """The reference's ``jnp.linspace(0, cutoff, n_rbf)`` in fp32: centre
    i is i * fp32(cutoff / (n_rbf - 1)), the last one ``cutoff``.  Bit
    for bit at the registry's widths (``torch.linspace`` rounds 124 of
    the 300 published centres otherwise)."""
    step = float(np.float32(cutoff) / np.float32(max(n_rbf - 1, 1)))
    c = torch.arange(n_rbf, dtype=torch.float32, device=device) * step
    if n_rbf > 1:
        c[-1] = cutoff
    return c


def rbf_expand(dist, n_rbf: int, cutoff: float,
               centers: Optional[torch.Tensor] = None):
    """Gaussian radial basis: [E] -> [E, n_rbf] (``centers``: those of
    :func:`rbf_centers`, made on ``dist``'s device when not given)."""
    if centers is None:
        centers = rbf_centers(n_rbf, cutoff, dist.device)
    gamma = (n_rbf / cutoff) ** 2 * 0.5
    return torch.exp(-gamma * torch.square(dist[:, None] - centers[None, :]))


def init_schnet(cfg: GNNConfig, gen: torch.Generator, d_feat: int,
                n_atom_types: int = 100, n_out: int = 1,
                device="cuda") -> dict:
    """Random parameters of the reference's shapes, dtypes and scales
    (``dense_init``'s fan-in scale; the atom table at 1.0), drawn from
    ``gen`` on its device and placed on ``device`` (the reference's
    ``jax.random`` stream is not reproduced: tests carry a reference
    tree across with ``core.convert.gnn_params_from_numpy``)."""
    dt = getattr(torch, cfg.param_dtype)
    h, r = cfg.d_hidden, cfg.n_rbf

    def dense(shape, scale=None):
        return L.dense_init(gen, shape, dt, scale).to(device)

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=device)

    params = {
        "embed_feat": dense((d_feat, h)),
        "embed_atom": dense((n_atom_types, h), scale=1.0),
        "out1": dense((h, h // 2)),
        "out2": dense((h // 2, n_out)),
        "interactions": [],
    }
    for _ in range(cfg.n_interactions):
        params["interactions"].append({
            "filt1": dense((r, h)), "filt1_b": zeros(h),
            "filt2": dense((h, h)), "filt2_b": zeros(h),
            "in2f": dense((h, h)), "f2out": dense((h, h)),
            "atom1": dense((h, h)), "atom2": dense((h, h)),
        })
    return params


def schnet_param_specs(cfg: GNNConfig) -> dict:
    """Logical specs of :func:`init_schnet`'s tree: d_hidden is 64, so
    everything replicates (the reference's)."""
    rep2, rep1 = (None, None), (None,)
    inter = {"filt1": rep2, "filt1_b": rep1, "filt2": rep2, "filt2_b": rep1,
             "in2f": rep2, "f2out": rep2, "atom1": rep2, "atom2": rep2}
    return {
        "embed_feat": rep2, "embed_atom": rep2, "out1": rep2, "out2": rep2,
        "interactions": [dict(inter) for _ in range(cfg.n_interactions)],
    }


class GraphBatch(NamedTuple):
    """Padded graph batch.  For featureful graphs, node_feat is float
    [N, d_feat]; for molecules, atom_type int [N].  edge_dist carries the
    continuous filter input."""
    node_feat: Optional[torch.Tensor]
    atom_type: Optional[torch.Tensor]
    src: torch.Tensor          # int32[E]
    dst: torch.Tensor          # int32[E]
    edge_dist: torch.Tensor    # float[E]
    graph_id: torch.Tensor     # int32[N] (zeros for single graph)
    n_graphs: int


def _mm(x, w, cdt):
    """``x @ w.astype(cdt)`` with JAX's promotion (an fp32 ``x`` keeps a
    bf16 product in fp32)."""
    dt = torch.promote_types(x.dtype, cdt)
    return x.to(dt) @ w.to(dt)


def _segment_sum(data, segment_ids, num_segments: int):
    # out of place: on a DTensor the sum's placement differs from the
    # zeros' (edge-sharded messages give partial sums)
    return data.new_zeros((num_segments,) + data.shape[1:]).index_add(
        0, segment_ids, data)


def schnet_forward(params, g: GraphBatch, cfg: GNNConfig,
                   centers: Optional[torch.Tensor] = None):
    """``(per-node outputs [N, n_out], per-graph readout [n_graphs,
    n_out])``."""
    cdt = getattr(torch, cfg.compute_dtype)
    if g.node_feat is not None:
        x = _mm(g.node_feat.to(cdt), params["embed_feat"], cdt)
    else:
        x = params["embed_atom"].to(cdt).index_select(0, g.atom_type)
    n_nodes = x.shape[0]
    rbf = rbf_expand(g.edge_dist.to(cdt), cfg.n_rbf, cfg.cutoff, centers)
    rbf = constrain(rbf, "edges", None)

    for p in params["interactions"]:
        w = ssp(_mm(rbf, p["filt1"], cdt) + p["filt1_b"].to(cdt))
        w = _mm(w, p["filt2"], cdt) + p["filt2_b"].to(cdt)     # [E, h]
        h_in = _mm(x, p["in2f"], cdt)
        msg = h_in.index_select(0, g.src) * w                    # [E, h]
        agg = _segment_sum(msg, g.dst, n_nodes)
        v = ssp(_mm(agg, p["f2out"], cdt))
        v = _mm(ssp(_mm(v, p["atom1"], cdt)), p["atom2"], cdt)
        x = x + v

    out = _mm(ssp(_mm(x, params["out1"], cdt)), params["out2"], cdt)
    energy = _segment_sum(out, g.graph_id, g.n_graphs)
    return out, energy  # per-node outputs, per-graph readout


def schnet_loss(params, g: GraphBatch, targets, cfg: GNNConfig):
    _, energy = schnet_forward(params, g, cfg)
    return torch.mean(torch.square(energy[:, 0].float() - targets.float()))
