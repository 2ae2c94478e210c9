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

The reference's sharding annotations are kept: the ``*_param_specs``
helpers (the third entry of :data:`FORWARDS`) give each leaf's logical
spec, and the forwards call ``dist.sharding.constrain`` where the
reference does (a no-op on one device). On a mesh of ranks the tables
are ``DTensor``s sharded by rows as those specs say, and every table
read passes the ``DTensor`` to ``ops.embedding_bag`` unchanged (its
row-sharded route); ``init_*(..., table_rows=(lo, hi))`` makes one
rank's block of rows of the tables from the same seeded stream. The
forwards train as they are: ``ops.embedding_bag`` is differentiable in
the table (on the card through the ``embedding_bag_backward`` kernel),
and :func:`bce_loss` is the reference's. DIEN's two ``lax.scan``s are
Python loops over T with the same masking. JAX promotes a mixed-dtype
product (fp32 activations @ bf16 weights -> fp32) where torch raises, so
every product here casts both operands to the promoted dtype
(:func:`_dot`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.dist.sharding import constrain
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
               dtype, device=None, *, rows=None) -> torch.Tensor:
    """Normal(0, 0.01) rows, ``padded_rows(total_rows)`` of them, drawn in
    fp32 in chunks of 2**26 values and cast chunk by chunk, so no fp32
    copy of a narrower table ever exists (DLRM-MLPerf's bf16 table is
    44.8 GiB).  On ``meta`` the table is a shape alone.

    ``rows=(lo, hi)`` keeps rows ``[lo, hi)`` of the padded table alone
    (one rank's block of a table sharded by rows): every chunk is still
    drawn, in order, and its part in the window kept, so the block holds
    the whole table's rows bit for bit, the generator ends where the
    whole draw leaves it (the parameters drawn after the table are the
    same), and no rank ever holds the whole table."""
    dev = L.draw_device(gen, device)
    R = padded_rows(total_rows)
    lo, hi = (0, R) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= lo <= hi <= R:
        raise ValueError(f"init_table: rows [{lo}, {hi}) outside the "
                         f"padded table's {R}")
    out = torch.empty((hi - lo, dim), dtype=dtype, device=dev)
    if dev.type == "meta":
        return out
    step = max(1, (1 << 26) // max(dim, 1))
    for s in range(0, R, step):
        n = min(step, R - s)
        chunk = torch.randn((n, dim), generator=gen, dtype=torch.float32,
                            device=dev).mul_(0.01)
        a, b = max(s, lo), min(s + n, hi)
        if a < b:
            out[a - lo:b - lo] = chunk[a - s:b - s]
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
    # a scatter-add, not ``bincount``: the same counts, and it has a
    # shape on ``meta``
    counts = torch.zeros(num_bags + 1, dtype=torch.int64,
                         device=seg.device).scatter_add_(
        0, seg, torch.ones_like(seg))
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


def _mlp_init(gen, dims: Tuple[int, ...], dtype, device=None):
    dev = L.draw_device(gen, device)
    return [{"w": L.dense_init(gen, (dims[i], dims[i + 1]), dtype,
                               device=dev),
             "b": torch.zeros((dims[i + 1],), dtype=dtype, device=dev)}
            for i in range(len(dims) - 1)]


def _mlp_specs(dims):
    return [{"w": (None, None), "b": (None,)} for _ in range(len(dims) - 1)]


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
def init_dlrm(cfg: RecsysConfig, gen: torch.Generator,
              device=None, table_rows=None) -> dict:
    dt = _dtype(cfg.param_dtype)
    n_f = cfg.n_sparse + 1
    n_inter = n_f * (n_f - 1) // 2
    top_in = cfg.bot_mlp[-1] + n_inter
    return {
        "table": init_table(gen, cfg.total_rows, cfg.embed_dim, dt, device,
                            rows=table_rows),
        "bot": _mlp_init(gen, cfg.bot_mlp, dt, device),
        "top": _mlp_init(gen, (top_in, *cfg.top_mlp), dt, device),
    }


def dlrm_param_specs(cfg: RecsysConfig) -> dict:
    return {"table": ("rows", None),
            "bot": _mlp_specs(cfg.bot_mlp),
            "top": _mlp_specs((0, *cfg.top_mlp))}


def dlrm_forward(params, batch: RecsysBatch, cfg: RecsysConfig,
                 offsets) -> torch.Tensor:
    cdt = _dtype(cfg.compute_dtype)
    d = _mlp_apply(params["bot"], batch.dense.to(cdt), final_act=True)
    e = embedding_lookup(params["table"], batch.sparse, offsets)  # [B,F,D]
    e = constrain(e, "batch", None, None)
    feats = torch.cat([d[:, None, :].to(cdt), e.to(cdt)], dim=1)
    inter = torch.bmm(feats, feats.transpose(1, 2))
    f = feats.shape[1]
    iu, ju = torch.triu_indices(f, f, offset=1, device=feats.device)
    # the upper triangle by one flat gather (``inter[:, iu, ju]``'s
    # values; its backward is an ``index_add``, where the advanced
    # index's is an ``index_put`` with a None index, which DTensor's
    # strategy in torch 2.11 cannot take)
    upper = inter.reshape(inter.shape[0], f * f).index_select(1, iu * f + ju)
    z = torch.cat([d.to(cdt), upper], dim=-1)
    return _mlp_apply(params["top"], z)[:, 0]


# ---------------------------------------------------------------------------
# DCN-v2 (cross network)  [arXiv:2008.13535]
# ---------------------------------------------------------------------------
def init_dcn(cfg: RecsysConfig, gen: torch.Generator, device=None,
             table_rows=None) -> dict:
    dt = _dtype(cfg.param_dtype)
    dev = L.draw_device(gen, device)
    d0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
    return {
        "table": init_table(gen, cfg.total_rows, cfg.embed_dim, dt, dev,
                            rows=table_rows),
        "cross": [{"w": L.dense_init(gen, (d0, d0), dt, device=dev),
                   "b": torch.zeros((d0,), dtype=dt, device=dev)}
                  for _ in range(cfg.n_cross_layers)],
        "mlp": _mlp_init(gen, (d0, *cfg.top_mlp), dt, dev),
        "head": L.dense_init(gen, (cfg.top_mlp[-1] + d0, 1), dt, device=dev),
    }


def dcn_param_specs(cfg: RecsysConfig) -> dict:
    return {
        "table": ("rows", None),
        "cross": [{"w": (None, None), "b": (None,)}
                  for _ in range(cfg.n_cross_layers)],
        "mlp": _mlp_specs((0, *cfg.top_mlp)),
        "head": (None, None),
    }


def dcn_forward(params, batch: RecsysBatch, cfg: RecsysConfig,
                offsets) -> torch.Tensor:
    cdt = _dtype(cfg.compute_dtype)
    e = embedding_lookup(params["table"], batch.sparse, offsets)
    e = constrain(e, "batch", None, None).to(cdt)
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
def init_xdeepfm(cfg: RecsysConfig, gen: torch.Generator,
                 device=None, table_rows=None) -> dict:
    dt = _dtype(cfg.param_dtype)
    dev = L.draw_device(gen, device)
    m = cfg.n_sparse
    cin = []
    h_prev = m
    table = init_table(gen, cfg.total_rows, cfg.embed_dim, dt, dev,
                       rows=table_rows)
    for h in cfg.cin_layers:
        cin.append(L.dense_init(gen, (h_prev, m, h), dt, device=dev))
        h_prev = h
    return {
        "table": table,
        "linear": init_table(gen, cfg.total_rows, 1, dt, dev,
                             rows=table_rows),
        "cin": cin,
        "dnn": _mlp_init(gen, (m * cfg.embed_dim, *cfg.top_mlp), dt, dev),
        "head": L.dense_init(
            gen, (sum(cfg.cin_layers) + cfg.top_mlp[-1] + 1, 1), dt,
            device=dev),
    }


def xdeepfm_param_specs(cfg: RecsysConfig) -> dict:
    return {
        "table": ("rows", None),
        "linear": ("rows", None),
        "cin": [(None, None, None) for _ in cfg.cin_layers],
        "dnn": _mlp_specs((0, *cfg.top_mlp)),
        "head": (None, None),
    }


def xdeepfm_forward(params, batch: RecsysBatch, cfg: RecsysConfig,
                    offsets) -> torch.Tensor:
    cdt = _dtype(cfg.compute_dtype)
    x0 = embedding_lookup(params["table"], batch.sparse, offsets)
    x0 = constrain(x0, "batch", None, None).to(cdt)        # [B, m, D]
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
def _gru_init(gen, d_in, d_h, dtype, device=None):
    dev = L.draw_device(gen, device)
    return {
        "wi": L.dense_init(gen, (d_in, 3 * d_h), dtype, device=dev),
        "wh": L.dense_init(gen, (d_h, 3 * d_h), dtype, device=dev),
        "b": torch.zeros((3 * d_h,), dtype=dtype, device=dev),
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


def init_dien(cfg: RecsysConfig, gen: torch.Generator, device=None,
              table_rows=None) -> dict:
    dt = _dtype(cfg.param_dtype)
    dev = L.draw_device(gen, device)
    d_e = cfg.embed_dim * 2  # item + category embedding
    return {
        "table": init_table(gen, cfg.total_rows, cfg.embed_dim, dt, dev,
                            rows=table_rows),
        "gru": _gru_init(gen, d_e, cfg.gru_dim, dt, dev),
        "augru": _gru_init(gen, d_e, cfg.gru_dim, dt, dev),
        "att": L.dense_init(gen, (cfg.gru_dim + d_e, 1), dt, device=dev),
        "mlp": _mlp_init(gen, (cfg.gru_dim + 2 * d_e, *cfg.top_mlp, 1), dt,
                         dev),
    }


def dien_param_specs(cfg: RecsysConfig) -> dict:
    g = {"wi": (None, None), "wh": (None, None), "b": (None,)}
    return {"table": ("rows", None), "gru": dict(g), "augru": dict(g),
            "att": (None, None),
            "mlp": _mlp_specs((0, *cfg.top_mlp, 1))}


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
    he = constrain(he, "batch", None, None)
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
    "dot": (init_dlrm, dlrm_forward, dlrm_param_specs),
    "cross": (init_dcn, dcn_forward, dcn_param_specs),
    "cin": (init_xdeepfm, xdeepfm_forward, xdeepfm_param_specs),
    "augru": (init_dien, dien_forward, dien_param_specs),
}
