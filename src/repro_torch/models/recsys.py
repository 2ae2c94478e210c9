"""Recsys models: DLRM (dot), DCN-v2 (cross), xDeepFM (CIN), DIEN (AUGRU)
— the serving half of the reference's ``models/recsys.py``.

Per-field tables are concatenated into one ``[total_rows, dim]`` matrix
with per-field row offsets, padded to a multiple of ``ROW_PAD`` rows.
Every table read is one ``ops.embedding_bag`` call (the CUDA kernel on
the card, its plain version on the CPU): one id per field is B·F bags of
one row (:func:`embedding_lookup`), and the pooled reads — xDeepFM's
linear term, DIEN's history mean, the retrieval user vector — are bags
of many rows.  Bags return fp32; :func:`embedding_lookup` casts back to
the table's dtype, as the reference's ``jnp.take`` returns it (exact:
the values came from that dtype).

There is one device, so the reference's sharding constraints are gone;
the ``*_param_specs`` helpers wait for ROADMAP.md Queue 1 item 12 part
6.  The forwards train as they are: ``ops.embedding_bag`` is
differentiable in the table (on the card through the
``embedding_bag_backward`` kernel), and :func:`bce_loss` is the
reference's.  DIEN's two ``lax.scan``s are Python loops over T with the
same masking.  JAX promotes a mixed-dtype product
(fp32 activations @ bf16 weights -> fp32) where torch raises, so every
product here casts both operands to the promoted dtype (:func:`_dot`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L


# ---------------------------------------------------------------------------
# EmbeddingBag substrate
# ---------------------------------------------------------------------------
def field_offsets(vocab_sizes, device="cuda") -> torch.Tensor:
    off = np.zeros(len(vocab_sizes), np.int64)
    off[1:] = np.cumsum(vocab_sizes)[:-1]
    return torch.as_tensor(off, dtype=torch.int32, device=device)


ROW_PAD = 512  # tables pad to a multiple of the reference's largest
               # sharding ways (pod*data*model = 512); in-vocab ids never
               # address the padded rows.


def padded_rows(total_rows: int) -> int:
    return -(-total_rows // ROW_PAD) * ROW_PAD


def init_table(gen: torch.Generator, total_rows: int, dim: int,
               dtype) -> torch.Tensor:
    """Normal(0, 0.01) rows, ``padded_rows(total_rows)`` of them, drawn in
    fp32 in chunks of 2**26 values and cast chunk by chunk, so no fp32
    copy of a narrower table ever exists (DLRM-MLPerf's bf16 table is
    44.8 GiB)."""
    rows = padded_rows(total_rows)
    out = torch.empty((rows, dim), dtype=dtype, device=gen.device)
    step = max(1, (1 << 26) // max(dim, 1))
    for s in range(0, rows, step):
        n = min(step, rows - s)
        out[s:s + n] = torch.randn((n, dim), generator=gen,
                                   dtype=torch.float32,
                                   device=gen.device).mul_(0.01)
    return out


def _single_rows(n: int, device) -> torch.Tensor:
    """CSR offsets of ``n`` bags of one row each."""
    return torch.arange(n + 1, dtype=torch.int32, device=device)


def embedding_lookup(table, idx_per_field, offsets):
    """idx_per_field: int32[B, F] (one id per field) -> [B, F, D] in the
    table's dtype: B·F single-row bags.

    The flattened index (id + its field's offset) clips to the whole
    padded table, as the reference's code does: an out-of-vocabulary id
    of field f reads a row of field f + 1 (ROADMAP.md Queue 3, reference
    quirks)."""
    flat = (idx_per_field + offsets[None, :]).reshape(-1)
    rows = ops.embedding_bag(table, flat, _single_rows(flat.shape[0],
                                                       table.device))
    return rows.to(table.dtype).reshape(*idx_per_field.shape,
                                        table.shape[-1])


def embedding_bag(table, indices, segments, num_bags, mode="sum"):
    """Multi-hot bag lookup (the reference's signature): ``indices``
    int32[nnz] rows, ``segments`` int32[nnz] each one's bag id (any
    order; ids outside ``[0, num_bags)`` belong to no bag) ->
    ``[num_bags, D]`` in the table's dtype.  Rows are grouped into CSR
    bags by a stable sort on the bag id, so each bag sums in index
    order; row ids clip into the table."""
    seg = segments.long()
    seg = torch.where((seg >= 0) & (seg < num_bags), seg, num_bags)
    order = torch.argsort(seg, stable=True)
    counts = torch.bincount(seg, minlength=num_bags + 1)
    csr = torch.zeros(num_bags + 2, dtype=torch.int32, device=table.device)
    csr[1:] = torch.cumsum(counts, 0)
    out = ops.embedding_bag(table, indices[order].to(torch.int32), csr, mode)
    return out[:num_bags].to(table.dtype)


def _pooled(table, flat_ids, bag_len: int, mode: str):
    """Bags of ``bag_len`` consecutive ids of ``flat_ids`` (int32, its
    size a multiple of ``bag_len``) -> fp32 [n / bag_len, D]."""
    n = flat_ids.shape[0]
    csr = torch.arange(0, n + 1, bag_len, dtype=torch.int32,
                       device=table.device)
    return ops.embedding_bag(table, flat_ids, csr, mode)


def _dot(a, b):
    """``a @ b`` in the promoted dtype of the two (JAX's promotion)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _mlp_init(gen, dims: Tuple[int, ...], dtype):
    return [{"w": L.dense_init(gen, (dims[i], dims[i + 1]), dtype),
             "b": torch.zeros((dims[i + 1],), dtype=dtype,
                              device=gen.device)}
            for i in range(len(dims) - 1)]


def _mlp_apply(layers_, x, final_act=False):
    for i, p in enumerate(layers_):
        x = _dot(x, p["w"]) + p["b"]
        if i < len(layers_) - 1 or final_act:
            x = torch.relu(x)
    return x


class RecsysBatch(NamedTuple):
    dense: Optional[torch.Tensor]        # float[B, n_dense]
    sparse: torch.Tensor                 # int32[B, n_sparse]
    label: Optional[torch.Tensor]        # float[B]
    hist: Optional[torch.Tensor] = None      # int32[B, T, 2] (DIEN)
    hist_len: Optional[torch.Tensor] = None  # int32[B]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# DLRM (dot interaction)  [arXiv:1906.00091]
# ---------------------------------------------------------------------------
def init_dlrm(cfg: RecsysConfig, gen: torch.Generator) -> dict:
    dt = _dtype(cfg.param_dtype)
    n_f = cfg.n_sparse + 1
    n_inter = n_f * (n_f - 1) // 2
    top_in = cfg.bot_mlp[-1] + n_inter
    return {
        "table": init_table(gen, cfg.total_rows, cfg.embed_dim, dt),
        "bot": _mlp_init(gen, cfg.bot_mlp, dt),
        "top": _mlp_init(gen, (top_in, *cfg.top_mlp), dt),
    }


def dlrm_forward(params, batch: RecsysBatch, cfg: RecsysConfig,
                 offsets) -> torch.Tensor:
    cdt = _dtype(cfg.compute_dtype)
    d = _mlp_apply(params["bot"], batch.dense.to(cdt), final_act=True)
    e = embedding_lookup(params["table"], batch.sparse, offsets)  # [B,F,D]
    feats = torch.cat([d[:, None, :].to(cdt), e.to(cdt)], dim=1)
    inter = torch.bmm(feats, feats.transpose(1, 2))
    f = feats.shape[1]
    iu, ju = torch.triu_indices(f, f, offset=1, device=feats.device)
    z = torch.cat([d.to(cdt), inter[:, iu, ju]], dim=-1)
    return _mlp_apply(params["top"], z)[:, 0]


# ---------------------------------------------------------------------------
# DCN-v2 (cross network)  [arXiv:2008.13535]
# ---------------------------------------------------------------------------
def init_dcn(cfg: RecsysConfig, gen: torch.Generator) -> dict:
    dt = _dtype(cfg.param_dtype)
    d0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
    return {
        "table": init_table(gen, cfg.total_rows, cfg.embed_dim, dt),
        "cross": [{"w": L.dense_init(gen, (d0, d0), dt),
                   "b": torch.zeros((d0,), dtype=dt, device=gen.device)}
                  for _ in range(cfg.n_cross_layers)],
        "mlp": _mlp_init(gen, (d0, *cfg.top_mlp), dt),
        "head": L.dense_init(gen, (cfg.top_mlp[-1] + d0, 1), dt),
    }


def dcn_forward(params, batch: RecsysBatch, cfg: RecsysConfig,
                offsets) -> torch.Tensor:
    cdt = _dtype(cfg.compute_dtype)
    e = embedding_lookup(params["table"], batch.sparse, offsets).to(cdt)
    x0 = torch.cat([batch.dense.to(cdt), e.reshape(e.shape[0], -1)], dim=-1)
    x = x0
    for p in params["cross"]:
        x = x0 * (_dot(x, p["w"]) + p["b"]) + x      # x0 ⊙ (Wx + b) + x
    deep = _mlp_apply(params["mlp"], x0, final_act=True)
    z = torch.cat([x, deep.to(x.dtype)], dim=-1)
    return _dot(z, params["head"])[:, 0]


# ---------------------------------------------------------------------------
# xDeepFM (Compressed Interaction Network)  [arXiv:1803.05170]
# ---------------------------------------------------------------------------
def init_xdeepfm(cfg: RecsysConfig, gen: torch.Generator) -> dict:
    dt = _dtype(cfg.param_dtype)
    m = cfg.n_sparse
    cin = []
    h_prev = m
    table = init_table(gen, cfg.total_rows, cfg.embed_dim, dt)
    for h in cfg.cin_layers:
        cin.append(L.dense_init(gen, (h_prev, m, h), dt))
        h_prev = h
    return {
        "table": table,
        "linear": init_table(gen, cfg.total_rows, 1, dt),
        "cin": cin,
        "dnn": _mlp_init(gen, (m * cfg.embed_dim, *cfg.top_mlp), dt),
        "head": L.dense_init(
            gen, (sum(cfg.cin_layers) + cfg.top_mlp[-1] + 1, 1), dt),
    }


def xdeepfm_forward(params, batch: RecsysBatch, cfg: RecsysConfig,
                    offsets) -> torch.Tensor:
    cdt = _dtype(cfg.compute_dtype)
    x0 = embedding_lookup(params["table"], batch.sparse, offsets).to(cdt)
    # CIN
    xk = x0
    pooled = []
    for w in params["cin"]:
        z = torch.einsum("bhd,bmd->bhmd", xk, x0)              # outer product
        xk = torch.einsum("bhmd,hmn->bnd", z, w.to(cdt))       # compress
        pooled.append(torch.sum(xk, dim=-1))                   # [B, H_k]
    cin_out = torch.cat(pooled, dim=-1)
    # DNN
    dnn_out = _mlp_apply(params["dnn"], x0.reshape(x0.shape[0], -1),
                         final_act=True)
    # Linear: one sum-bag of the F field rows per sample
    flat = (batch.sparse + offsets[None, :]).reshape(-1)
    lin = _pooled(params["linear"], flat, batch.sparse.shape[1],
                  "sum").to(cdt)                               # [B, 1]
    z = torch.cat([cin_out, dnn_out.to(cdt), lin], dim=-1)
    return _dot(z, params["head"])[:, 0]


# ---------------------------------------------------------------------------
# DIEN (interest evolution: GRU + attention + AUGRU)  [arXiv:1809.03672]
# ---------------------------------------------------------------------------
def _gru_init(gen, d_in, d_h, dtype):
    return {
        "wi": L.dense_init(gen, (d_in, 3 * d_h), dtype),
        "wh": L.dense_init(gen, (d_h, 3 * d_h), dtype),
        "b": torch.zeros((3 * d_h,), dtype=dtype, device=gen.device),
    }


def _gru_cell(p, h, x, a=None):
    """GRU step; ``a`` (optional [B,1]) turns it into AUGRU (attention
    gates the update gate — DIEN eq. 5)."""
    xi = _dot(x, p["wi"]) + p["b"]
    hh = _dot(h, p["wh"])
    xi_r, xi_u, xi_c = torch.chunk(xi, 3, dim=-1)
    hh_r, hh_u, hh_c = torch.chunk(hh, 3, dim=-1)
    r = torch.sigmoid(xi_r + hh_r)
    u = torch.sigmoid(xi_u + hh_u)
    cand = torch.tanh(xi_c + r * hh_c)
    if a is not None:
        u = u * a
    return (1.0 - u) * h + u * cand


def init_dien(cfg: RecsysConfig, gen: torch.Generator) -> dict:
    dt = _dtype(cfg.param_dtype)
    d_e = cfg.embed_dim * 2  # item + category embedding
    return {
        "table": init_table(gen, cfg.total_rows, cfg.embed_dim, dt),
        "gru": _gru_init(gen, d_e, cfg.gru_dim, dt),
        "augru": _gru_init(gen, d_e, cfg.gru_dim, dt),
        "att": L.dense_init(gen, (cfg.gru_dim + d_e, 1), dt),
        "mlp": _mlp_init(gen, (cfg.gru_dim + 2 * d_e, *cfg.top_mlp, 1), dt),
    }


def dien_forward(params, batch: RecsysBatch, cfg: RecsysConfig,
                 offsets) -> torch.Tensor:
    """batch.sparse: [B, 2] = (target item, target category);
    batch.hist: [B, T, 2] item+category history."""
    cdt = _dtype(cfg.compute_dtype)
    B, T = batch.hist.shape[0], batch.hist.shape[1]
    table = params["table"]
    tgt = embedding_lookup(table, batch.sparse, offsets)
    tgt = tgt.reshape(B, -1).to(cdt)                            # [B, 2D]
    he = embedding_lookup(table, batch.hist.reshape(B * T, 2), offsets)
    he = he.reshape(B, T, -1).to(cdt)                           # [B, T, 2D]
    mask = (torch.arange(T, device=he.device)[None, :]
            < batch.hist_len[:, None])

    # Interest extraction: GRU over history
    h = torch.zeros((B, cfg.gru_dim), dtype=cdt, device=he.device)
    hs = []
    for t in range(T):
        h2 = _gru_cell(params["gru"], h, he[:, t])
        h = torch.where(mask[:, t, None], h2, h)
        hs.append(h)
    hs = torch.stack(hs, dim=1)                                 # [B, T, H]

    # Attention scores vs target
    att_in = torch.cat([hs, tgt[:, None].expand(B, T, tgt.shape[-1])], -1)
    scores = _dot(att_in, params["att"])[..., 0]
    scores = torch.where(mask, scores, -1e30)
    alpha = torch.softmax(scores.float(), -1).to(cdt)

    # Interest evolution: AUGRU over history
    h = torch.zeros((B, cfg.gru_dim), dtype=cdt, device=he.device)
    for t in range(T):
        h2 = _gru_cell(params["augru"], h, he[:, t], alpha[:, t, None])
        h = torch.where(mask[:, t, None], h2, h)

    # History mean: per (sample, field), a mean-bag of the T history rows
    flat = (batch.hist + offsets[None, None, :]).transpose(1, 2).reshape(-1)
    hist_mean = _pooled(table, flat, T, "mean").reshape(B, -1).to(cdt)
    z = torch.cat([h, tgt, hist_mean], dim=-1)
    return _mlp_apply(params["mlp"], z)[:, 0]


# ---------------------------------------------------------------------------
# Retrieval scoring (retrieval_cand shape): 1 query vs N candidates
# ---------------------------------------------------------------------------
def retrieval_scores(table, user_vec, cand_ids):
    """Batched dot scoring of one fp32 user vector against N candidate
    item embeddings (N single-row bags; ids clip into the table)."""
    cand = ops.embedding_bag(table, cand_ids.to(torch.int32),
                             _single_rows(cand_ids.shape[0], table.device))
    d = min(user_vec.shape[-1], cand.shape[-1])
    return cand[:, :d] @ user_vec[:d].float()


# ---------------------------------------------------------------------------
# Shared loss
# ---------------------------------------------------------------------------
def bce_loss(logits, labels):
    """Mean binary cross-entropy of fp32 logits, the stable form.  At a
    logit of exactly 0 the gradient is JAX's: ``maximum`` splits it in
    half and ``|x|`` counts as x (torch's ``abs`` would give 0)."""
    logits = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    absl = torch.where(logits >= 0, logits, -logits)
    return torch.mean(torch.maximum(logits, logits.new_zeros(()))
                      - logits * labels + torch.log1p(torch.exp(-absl)))


FORWARDS = {
    "dot": (init_dlrm, dlrm_forward),
    "cross": (init_dcn, dcn_forward),
    "cin": (init_xdeepfm, xdeepfm_forward),
    "augru": (init_dien, dien_forward),
}
