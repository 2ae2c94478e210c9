"""The recsys steps on real ranks: a table sharded by rows, each rank
bagging its own rows through a row window (``kernels/ops.py``'s sharded
route).

* **The window.**  The windowed plain versions (``ref.embedding_bag_ref``
  and ``ref.embedding_bag_backward_ref`` with ``row_lo``/``row_hi``) at
  S = 1, 2 and 4 windows: the windows' bags sum to the whole-table bag
  within 1e-6 (the port's, the JAX oracle's
  ``repro.kernels.ref.embedding_bag_ref`` and the Pallas kernel's in
  interpret mode, ``src/repro/kernels/embedding_bag.py:61``), single-row
  bags bit for bit (and the reference's ``embedding_lookup``,
  ``src/repro/models/recsys.py:49``); the backward windows concatenate
  to the whole-table backward bit for bit and lie within 1e-6 of
  ``jax.grad`` of the reference's lookup and multi-hot bag; the default
  window is the seed's call bit for bit.  The card kernels' own window
  logic is mirrored here: the forward's order (``in_order_bags``) and a
  numpy walk of the backward kernel's chunks with the window's phase,
  whose windows concatenate to the whole walk bit for bit.
  ``init_table(rows=)`` makes each rank's rows of the same stream.
* **One world of four gloo CPU ranks** runs every case: the four archs'
  ``reduced_config`` (DLRM, DCN-v2, xDeepFM, DIEN) on a (2, 2)
  ``("data", "model")`` mesh with ``default_rules`` (rows over
  ``model``, the batch over ``data``), DLRM and DCN-v2 again with rows
  over ``("data", "model")`` (the index gather), and DCN-v2 on the card's
  (1, 4) layout; each a forward, two AdamW train steps (clip on) and,
  for DLRM and DCN-v2, the retrieval step, with parameters laid out by
  ``distribute_tree`` under ``use_rules``, ``implicit_replication`` and
  ``Resharding``.  Logits, losses, gathered parameters and moments are
  held within 1e-5 of the port's single-device steps and of the
  reference's jitted single-device steps (its own sharded step raises
  under the installed JAX, so the single-device steps are the oracles,
  as for the LM in ``tests/test_torch_spmd.py``); the table's gradient
  and moments carry the table's placements; each rank's local rows are
  its block of the whole table; the bag's reduce is issued through
  ``collectives.mesh_psum(x, "rows")``.  The world runs in subprocesses
  while this process jits the reference's steps, and is killed after
  240 s.
* **Refusals.**  A column-sharded table raises.
"""
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import recsys as JR
from repro.train import steps as JS
from repro.train.optimizer import AdamW as JAdamW
from repro_torch.configs import registry as treg
from repro_torch.core import convert
from repro_torch.dist import collectives as tcoll
from repro_torch.kernels import embedding_bag as teb
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import time_embedding_bag as tbag
from repro_torch.models import layers as TL
from repro_torch.models import recsys as TR
from repro_torch.train import steps as TS
from repro_torch.train import tree
from repro_torch.train.optimizer import AdamW as TAdamW

ROOT = pathlib.Path(__file__).resolve().parent.parent
WIN_TOL = dict(rtol=1e-6, atol=1e-6)     # sums of windows, grads vs jax
TOL = dict(rtol=1e-5, atol=1e-5)         # ranked steps vs single-device
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10)
B = 32                                   # the world's batch (data = 2)
WORLD_TIMEOUT = 240


# ---------------------------------------------------------------------------
# The window, on the plain versions
# ---------------------------------------------------------------------------
def _case(seed, R=1024, D=16, n_bags=40, max_len=12, clip=True, lead=3):
    """A table, CSR bags (empty ones, ``lead`` positions before the first
    bag, some after the last) and ids, out of range at both ends when
    ``clip``."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len + 1, n_bags)
    lens[rng.random(n_bags) < 0.15] = 0
    off = np.concatenate([[0], np.cumsum(lens)]) + lead
    n = int(off[-1]) + 5
    lo, hi = (-5, R + 5) if clip else (0, R)
    idx = rng.integers(lo, hi, n).astype(np.int32)
    idx[:4] = [lo, hi - 1, 0, R - 1]
    table = rng.normal(size=(R, D)).astype(np.float32)
    return table, idx, off.astype(np.int32)


def _windows(R, S):
    return [(k * R // S, (k + 1) * R // S) for k in range(S)]


def _t(*a):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in a]


def _window_sum(table, idx, off, mode, S):
    t, i, o = _t(table, idx, off)
    R = t.shape[0]
    parts = [tref.embedding_bag_ref(t[lo:hi], i, o, mode, row_lo=lo,
                                    row_hi=hi, num_rows=R)
             for lo, hi in _windows(R, S)]
    return parts, sum(parts[1:], parts[0])


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_window_bags_sum_to_the_whole_bag(S, mode):
    table, idx, off = _case(S)
    t, i, o = _t(table, idx, off)
    parts, total = _window_sum(table, idx, off, mode, S)
    whole = tref.embedding_bag_ref(t, i, o, mode)
    np.testing.assert_allclose(total.numpy(), whole.numpy(), **WIN_TOL)
    # the JAX oracle puts positions before offsets[0] in bag 0 (the
    # kernels' contract: in no bag), so it sees bags from position 0
    table, idx, off = _case(S, lead=0)
    _, total = _window_sum(table, idx, off, mode, S)
    oracle = jref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx),
                                    jnp.asarray(off), mode=mode)
    np.testing.assert_allclose(total.numpy(), np.asarray(oracle), **WIN_TOL)
    # the Pallas kernel reads ids as they are: in-range ids only
    table, idx, off = _case(S, clip=False, lead=0)
    _, total = _window_sum(table, idx, off, mode, S)
    pallas = jops.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                jnp.asarray(off), mode=mode, interpret=True)
    np.testing.assert_allclose(total.numpy(), np.asarray(pallas), **WIN_TOL)
    # a bag whose rows all lie outside a window is zero there
    table, idx, off = _case(S)
    t, i, o = _t(table, idx, off)
    for (lo, hi), part in zip(_windows(t.shape[0], S), parts):
        rows = i.long().clamp(0, t.shape[0] - 1)
        lens = (o[1:] - o[:-1]).long()
        none = torch.tensor([not bool(((rows[a:a + n] >= lo)
                                       & (rows[a:a + n] < hi)).any())
                             for a, n in zip(o[:-1].tolist(),
                                             lens.tolist())])
        assert not part[none].any()


@pytest.mark.parametrize("S", [1, 2, 4])
def test_single_row_windows_are_exact(S):
    """One id a field (B·F bags of one row): one window adds the row, the
    others zeros, so the sum is the row bit for bit, as the reference's
    ``jnp.take`` lookup reads it."""
    rng = np.random.default_rng(10 + S)
    vocab = (300, 200, 500)
    table = rng.normal(size=(TR.padded_rows(sum(vocab)), 8)
                       ).astype(np.float32)
    ids = np.stack([rng.integers(-2, v + 2, 64) for v in vocab],
                   1).astype(np.int32)
    foff = np.asarray(TR.field_offsets(vocab, device="cpu"))
    flat = (ids + foff[None, :]).reshape(-1)
    off = np.arange(flat.shape[0] + 1, dtype=np.int32)
    _, total = _window_sum(table, flat, off, "sum", S)
    want = JR.embedding_lookup(jnp.asarray(table), jnp.asarray(ids),
                               jnp.asarray(foff))
    assert np.array_equal(total.numpy().reshape(64, 3, 8), np.asarray(want))


def _grads(off, D, seed):
    """A cotangent of the bags, fp32 [B, D]."""
    return np.random.default_rng(seed).normal(
        size=(off.shape[0] - 1, D)).astype(np.float32)


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_backward_windows_concatenate_to_the_whole(S, mode):
    table, idx, off = _case(20 + S)
    g = _grads(off, table.shape[1], S)
    gt, i, o = _t(g, idx, off)
    R = table.shape[0]
    whole = tref.embedding_bag_backward_ref(gt, i, o, mode, R,
                                            torch.float32)
    parts = [tref.embedding_bag_backward_ref(gt, i, o, mode, R,
                                             torch.float32, row_lo=lo,
                                             row_hi=hi)
             for lo, hi in _windows(R, S)]
    assert torch.equal(torch.cat(parts), whole)
    # jax.grad of the reference's multi-hot bag over the same CSR bags
    n_bags = off.shape[0] - 1
    pos = np.arange(idx.shape[0])
    seg = np.searchsorted(off[1:], pos, side="right")
    seg = np.where((pos >= off[0]) & (pos < off[-1]), seg, n_bags)
    rows = np.clip(idx, 0, R - 1)

    def bag(t):
        return JR.embedding_bag(t, jnp.asarray(rows), jnp.asarray(seg),
                                n_bags + 1, mode)[:n_bags]
    want = jax.grad(lambda t: jnp.sum(bag(t) * jnp.asarray(g)))(
        jnp.asarray(table))
    np.testing.assert_allclose(torch.cat(parts).numpy(), np.asarray(want),
                               **WIN_TOL)


def test_lookup_backward_windows_match_jax_grad():
    """Single-row bags: the windows' gradient against ``jax.grad`` of the
    reference's ``embedding_lookup`` (a scatter-add of the cotangent)."""
    rng = np.random.default_rng(3)
    vocab = (300, 200, 500)
    R = TR.padded_rows(sum(vocab))
    table = rng.normal(size=(R, 8)).astype(np.float32)
    ids = np.stack([rng.integers(-2, v + 2, 64) for v in vocab],
                   1).astype(np.int32)
    foff = np.asarray(TR.field_offsets(vocab, device="cpu"))
    flat = (ids + foff[None, :]).reshape(-1)
    off = np.arange(flat.shape[0] + 1, dtype=np.int32)
    g = rng.normal(size=(flat.shape[0], 8)).astype(np.float32)
    gt, i, o = _t(g, flat, off)
    parts = [tref.embedding_bag_backward_ref(gt, i, o, "sum", R,
                                             torch.float32, row_lo=lo,
                                             row_hi=hi)
             for lo, hi in _windows(R, 4)]
    want = jax.grad(lambda t: jnp.sum(JR.embedding_lookup(
        t, jnp.asarray(ids), jnp.asarray(foff)) * jnp.asarray(
            g.reshape(64, 3, 8))))(jnp.asarray(table))
    np.testing.assert_allclose(torch.cat(parts).numpy(), np.asarray(want),
                               **WIN_TOL)


def _seed_bag(table, indices, offsets, mode="sum"):
    """The plain version as it was before the window (bit for bit)."""
    B_ = offsets.shape[0] - 1
    R, D = table.shape
    pos = torch.arange(indices.shape[0])
    ends = offsets[1:].long()
    seg = torch.searchsorted(ends, pos, right=True)
    seg = torch.where(pos >= offsets[0].long(), seg, B_)
    rows = table[indices.long().clamp(0, R - 1)].float()
    out = torch.zeros((B_ + 1, D), dtype=torch.float32)
    out.index_add_(0, seg, rows)
    out = out[:B_]
    if mode == "mean":
        cnt = (ends - offsets[:-1].long()).clamp(min=1)
        out = out / cnt.float()[:, None]
    return out


def _seed_backward(grad_out, indices, offsets, mode, num_rows, dtype):
    B_ = offsets.shape[0] - 1
    pos = torch.arange(indices.shape[0])
    ends = offsets[1:].long()
    seg = torch.searchsorted(ends, pos, right=True)
    inside = (pos >= offsets[0].long()) & (pos < offsets[B_].long())
    g = grad_out.float()
    if mode == "mean":
        cnt = (ends - offsets[:-1].long()).clamp(min=1)
        g = g / cnt.float()[:, None]
    rows = indices.long().clamp(0, num_rows - 1)
    out = torch.zeros((num_rows, grad_out.shape[1]), dtype=torch.float32)
    out.index_add_(0, rows[inside], g[seg[inside]])
    return out.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_whole_window_is_the_seed_call(dtype, mode):
    table, idx, off = _case(7)
    t, i, o = _t(table, idx, off)
    t = t.to(dtype)
    R = t.shape[0]
    want = _seed_bag(t, i, o, mode)
    for got in (tref.embedding_bag_ref(t, i, o, mode),
                tref.embedding_bag_ref(t, i, o, mode, row_lo=0, row_hi=R,
                                       num_rows=R),
                tops.embedding_bag(t, i, o, mode)):
        assert torch.equal(got, want)
    g = torch.from_numpy(_grads(off, table.shape[1], 1))
    want = _seed_backward(g, i, o, mode, R, dtype)
    for got in (tref.embedding_bag_backward_ref(g, i, o, mode, R, dtype),
                tref.embedding_bag_backward_ref(g, i, o, mode, R, dtype,
                                                row_lo=0, row_hi=R)):
        assert torch.equal(got, want)
    key, perm = teb.sort_positions(i, o, R)
    assert torch.equal(teb.sort_positions(i, o, R, 0, R)[0], key)


def test_in_order_windows_sum_to_the_whole():
    """The card kernels' forward order (``in_order_bags``) with a window:
    each window bit-equal to the windowed plain version on single-row
    bags, and the windows sum to the whole within 1e-6 (exactly on
    single-row bags)."""
    table, idx, off = _case(30)
    t, i, o = _t(table, idx, off)
    R = t.shape[0]
    for mode in ("sum", "mean"):
        parts = [tbag.in_order_bags(t[lo:hi], i, o, mode, row_lo=lo,
                                    row_hi=hi, num_rows=R)
                 for lo, hi in _windows(R, 4)]
        np.testing.assert_allclose(
            sum(parts[1:], parts[0]).numpy(),
            tbag.in_order_bags(t, i, o, mode).numpy(), **WIN_TOL)
    one = torch.arange(i.shape[0] + 1, dtype=torch.int32)
    for lo, hi in _windows(R, 4):
        assert torch.equal(
            tbag.in_order_bags(t[lo:hi], i, one, row_lo=lo, row_hi=hi,
                               num_rows=R),
            tref.embedding_bag_ref(t[lo:hi], i, one, row_lo=lo, row_hi=hi,
                                   num_rows=R))


def _mirror_backward(key, perm, bag_of, g, R, phase=None):
    """The backward kernel's order in numpy (``csrc/embedding_bag_
    backward.cu``, its chunk and combine kernels): chunks of
    ``BWD_CHUNK`` sorted entries (shifted by ``phase``), each run summed
    from 0.0 in order inside a chunk (a run that began earlier kept as
    the chunk's head, one that goes on as its tail), then each owning
    chunk's tail plus the heads after it."""
    C = teb.BWD_CHUNK
    N = key.shape[0]
    n_chunks = -(-N // C) + (phase is not None)
    ph = 0 if phase is None else phase
    out = np.zeros((R, g.shape[1]), np.float32)
    head = np.zeros((n_chunks, g.shape[1]), np.float32)
    tail = np.zeros_like(head)
    flags = np.zeros(n_chunks, np.int64)
    span = {}
    for c in range(n_chunks):
        s, e = max(c * C - ph, 0), min((c + 1) * C - ph, N)
        span[c] = (s, e)
        if s >= e or key[s] >= R:
            continue
        run, here = key[s], s == 0 or key[s - 1] != key[s]
        acc = np.zeros(g.shape[1], np.float32)
        stop = False
        for j in range(s, e):
            if key[j] >= R:
                stop = True
                break
            if key[j] != run:
                if here:
                    out[run] = acc
                else:
                    head[c] = acc
                acc = np.zeros(g.shape[1], np.float32)
                run, here = key[j], True
            acc = acc + g[bag_of[perm[j]]]
        ends = stop or e == N or key[e] != run
        if here and ends:
            out[run] = acc
        elif not here:
            head[c] = acc
            flags[c] = 0 if ends else 2
        else:
            tail[c] = acc
            flags[c] = 1
    for c in range(n_chunks):
        if flags[c] & 1:
            acc = tail[c].copy()
            c2 = c + 1
            while True:
                acc = acc + head[c2]
                if not flags[c2] & 2:
                    break
                c2 += 1
            out[key[span[c][1] - 1]] = acc
    return out


@pytest.mark.parametrize("S", [2, 4])
def test_backward_kernel_phase_keeps_the_whole_order(S):
    """The windowed backward kernel's plan, walked in numpy: the sort's
    keys, ``window_phase`` and the shifted chunks give each window's rows
    the whole call's chunk boundaries, so the windows concatenate to the
    whole walk bit for bit (rows of many contributions, runs across
    chunks, positions outside every bag and outside the window)."""
    rng = np.random.default_rng(40 + S)
    R, D = 64, 4
    n = 3000
    idx = np.minimum(rng.zipf(1.3, n) - 3, R + 3).astype(np.int32)
    off = np.sort(rng.integers(5, n - 5, 200)).astype(np.int32)
    off[0] = 5
    g = rng.normal(size=(off.shape[0] - 1, D)).astype(np.float32)
    i, o = _t(idx, off)
    pos = np.arange(n)
    bag_of = np.searchsorted(off[1:], pos, side="right")
    key, perm = teb.sort_positions(i, o, R)
    whole = _mirror_backward(key.numpy(), perm.numpy(), bag_of, g, R)
    parts = []
    for lo, hi in _windows(R, S):
        key, perm = teb.sort_positions(i, o, R, lo, hi)
        ph = int(teb.window_phase(i, o, R, lo)[0])
        parts.append(_mirror_backward(key.numpy(), perm.numpy(), bag_of, g,
                                      hi - lo, ph))
    assert np.array_equal(np.concatenate(parts), whole)
    np.testing.assert_allclose(
        whole, tref.embedding_bag_backward_ref(
            torch.from_numpy(g), i, o, "sum", R, torch.float32).numpy(),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dim", [1, 16])
def test_init_table_rows_are_the_whole_tables(dim):
    """``init_table(rows=)`` keeps its block of the same stream: the
    blocks concatenate to the whole table, and the generator ends where
    the whole draw leaves it (an arch's other leaves are the same)."""
    total = 5000
    whole_gen = TL.make_generator("cpu", 3)
    whole = TR.init_table(whole_gen, total, dim, torch.float32, "cpu")
    R = TR.padded_rows(total)
    blocks = []
    for lo, hi in _windows(R, 4):
        gen = TL.make_generator("cpu", 3)
        blocks.append(TR.init_table(gen, total, dim, torch.float32, "cpu",
                                    rows=(lo, hi)))
        assert torch.equal(gen.get_state(), whole_gen.get_state())
    assert torch.equal(torch.cat(blocks), whole)
    cfg, entry = treg.reduced_config("xdeepfm"), treg.get("xdeepfm")
    full = TS.init_params_for(entry, cfg, seed=1, device="cpu")
    R = TR.padded_rows(cfg.total_rows)
    part = TS.init_params_for(entry, cfg, seed=1, device="cpu",
                              table_rows=(R // 4, R // 2))
    for (path, a), (_, b) in zip(tree.items_with_path(full),
                                 tree.items_with_path(part)):
        if path[0] in ("table", "linear"):
            a = a[R // 4:R // 2]
        assert torch.equal(a, b), path


# ---------------------------------------------------------------------------
# One world of four gloo ranks
# ---------------------------------------------------------------------------
# (arch, layout, retrieval): layout "model" is default_rules on (2, 2),
# "dp_model" rows over ("data", "model") on (2, 2), "card" (1, 4)
CASES = [("dlrm-mlperf", "model", True), ("dcn-v2", "model", True),
         ("xdeepfm", "model", False), ("dien", "model", False),
         ("dlrm-mlperf", "dp_model", True), ("dcn-v2", "dp_model", True),
         ("dcn-v2", "card", False)]

WORLD = textwrap.dedent("""
    import sys
    import torch, torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import registry
    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import (Resharding, Rules, default_rules,
                                           distribute_tree, tree_shardings,
                                           use_rules)
    from repro_torch.launch import mesh as M
    from repro_torch.models import recsys as R
    from repro_torch.train import steps as S, tree
    from repro_torch.train.optimizer import AdamW

    rank, port, src, dst = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                            sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    data = torch.load(src)
    rows_ways = []
    real_psum = C.mesh_psum

    def spy(x, logical, rules=None):
        if logical == "rows":
            rows_ways.append(C.axis_size("rows", rules))
        return real_psum(x, logical, rules)
    C.mesh_psum = spy
    meshes = {"2x2": M.make_mesh((2, 2), ("data", "model"), "cpu"),
              "1x4": M.make_mesh((1, 4), ("data", "model"), "cpu")}

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def names(pl):
        return [[type(p).__name__, getattr(p, "dim", None)] for p in pl]

    out = {}
    for arch, layout, retrieval in data["cases"]:
        cfg, entry = registry.reduced_config(arch), registry.get(arch)
        mesh = meshes["1x4" if layout == "card" else "2x2"]
        rules = default_rules(mesh)
        if layout == "dp_model":
            rules = Rules(mesh, dict(rules.table, rows=("data", "model")))
        p0 = data["params"][arch]
        params = distribute_tree(p0, mesh, tree_shardings(
            rules, S.param_specs_for(entry, cfg)))

        def lay(batch):
            return {k: distribute_tensor(v, mesh, rules.placements(
                ("batch",) + (None,) * (v.dim() - 1)))
                for k, v in batch.items()}
        opt = AdamW(**data["opt"])
        n_psum = len(rows_ways)
        with use_rules(rules), implicit_replication(), Resharding():
            logits = S.make_recsys_forward(cfg, "cpu")(
                params, lay(data["serve"][arch]))
            leaves = [x.detach().requires_grad_(True)
                      for x in tree.leaves(params)]
            b = lay(data["train"][arch][0])
            fwd = S.make_recsys_forward(cfg, "cpu")
            loss = R.bce_loss(fwd(tree.unflatten(params, leaves), b),
                              b["label"])
            raw = torch.autograd.grad(loss, leaves)
            g = tree.unflatten(params, list(raw))["table"]
            # the staged layout against DTensor's own, leaf by leaf
            staged_err = max(
                float((C.local_as(x, p.placements) - x.redistribute(
                    p.device_mesh, p.placements).to_local()).abs().max())
                for x, p in zip(raw, leaves))
            # the step's gradient, reduced over the batch's dims
            _, grads = S._value_and_grad(
                lambda q, x: R.bce_loss(fwd(q, x), x["label"]), params, b)
            step = S.make_recsys_train_step(cfg, opt)
            p, state, losses = params, opt.init(params), []
            for batch in data["train"][arch]:
                p, state, m = step(p, state, lay(batch))
                losses.append(m["loss"])
            scores = None
            if retrieval:
                u, c = data["retrieval"][arch]
                scores = S.make_recsys_retrieval_step(cfg, "cpu")(
                    params, u, c)
        # this rank's block of the table: row-major over the rows' dims
        coord = mesh.get_coordinate()
        ways = [mesh.size(d) for d, n in enumerate(("data", "model"))
                if n in rules.axes("rows")]
        dims = [d for d, n in enumerate(("data", "model"))
                if n in rules.axes("rows")]
        k = 0
        for d in dims:
            k = k * mesh.size(d) + coord[d]
        n_blk = 1
        for w in ways:
            n_blk *= w
        rows = p0["table"].shape[0] // n_blk
        local_ok = bool(torch.equal(params["table"].to_local(),
                                    p0["table"][k * rows:(k + 1) * rows]))
        checks = {"local_ok": local_ok, "psum_ways": rows_ways[n_psum:],
                  "staged_err": staged_err}
        every = [None] * 4
        dist.all_gather_object(every, checks)
        res = {"logits": whole(logits),
               "losses": [float(whole(x)) for x in losses],
               "params": tree.tree_map(whole, p),
               "mu": tree.tree_map(whole, state.mu),
               "nu": tree.tree_map(whole, state.nu),
               "scores": None if scores is None else whole(scores),
               "placements": {
                   "table": names(params["table"].placements),
                   "raw_grad": names(g.placements),
                   "grad": names(grads["table"].placements),
                   "mu": names(state.mu["table"].placements),
                   "nu": names(state.nu["table"].placements),
                   "new": names(p["table"].placements)},
               "ranks": every}
        out[(arch, layout)] = res
    if rank == 0:
        torch.save(out, dst)
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_world(script: str, n: int, *args):
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    port = str(_free_port())
    return [subprocess.Popen(
        [sys.executable, "-c", script, str(r), port, *map(str, args)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(n)]


def _end_world(procs, timeout):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]


def _np_batch(cfg, n, rng):
    batch = {"sparse": np.stack([rng.integers(0, v, n)
                                 for v in cfg.vocab_sizes], 1
                                ).astype(np.int32),
             "label": rng.integers(0, 2, n).astype(np.float32)}
    if cfg.n_dense:
        batch["dense"] = rng.normal(size=(n, cfg.n_dense)).astype(np.float32)
    if cfg.interaction == "augru":
        batch["hist"] = np.stack(
            [rng.integers(0, cfg.vocab_sizes[0], (n, cfg.seq_len)),
             rng.integers(0, cfg.vocab_sizes[1], (n, cfg.seq_len))],
            -1).astype(np.int32)
        batch["hist_len"] = rng.integers(1, cfg.seq_len, n).astype(np.int32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the world, compute both packages' single-device oracles
    meanwhile, then collect the world's results."""
    tmp = tmp_path_factory.mktemp("rank_recsys")
    archs = sorted({a for a, _, _ in CASES})
    data = {"cases": CASES, "opt": OPT, "params": {}, "serve": {},
            "train": {}, "retrieval": {}}
    inputs = {}
    for arch in archs:
        jcfg, tcfg = jreg.reduced_config(arch), treg.reduced_config(arch)
        jp = JS.init_params_for(jreg.get(arch), jcfg, jax.random.PRNGKey(0))
        tp = convert.recsys_params_from_numpy(jax.tree.map(np.asarray, jp),
                                              tcfg, "cpu")
        rng = np.random.default_rng(5)
        serve = _np_batch(jcfg, B, rng)
        serve.pop("label")
        train = [_np_batch(jcfg, B, rng) for _ in range(2)]
        user = _np_batch(jcfg, 1, rng)["sparse"]
        cand = rng.integers(0, jcfg.total_rows, 500).astype(np.int32)
        data["params"][arch] = tp
        data["serve"][arch] = _torch(serve)
        data["train"][arch] = [_torch(b) for b in train]
        data["retrieval"][arch] = (torch.from_numpy(user),
                                   torch.from_numpy(cand))
        inputs[arch] = (jcfg, tcfg, jp, tp, serve, train, user, cand)
    torch.save(data, tmp / "in.pt")
    procs = _start_world(WORLD, 4, tmp / "in.pt", tmp / "out.pt")
    try:
        oracles = {}
        for arch, (jcfg, tcfg, jp, tp, serve, train, user, cand) in \
                inputs.items():
            single = {"logits": TS.make_recsys_forward(tcfg, "cpu")(
                tp, _torch(serve)),
                "scores": TS.make_recsys_retrieval_step(tcfg, "cpu")(
                    tp, torch.from_numpy(user), torch.from_numpy(cand))}
            ref = {"logits": jax.jit(JS.make_recsys_forward(jcfg))(
                jp, _jax(serve)),
                "scores": jax.jit(JS.make_recsys_retrieval_step(jcfg))(
                    jp, jnp.asarray(user), jnp.asarray(cand))}
            topt, jopt = TAdamW(**OPT), JAdamW(**OPT)
            ts, js = topt.init(tp), jopt.init(jp)
            tstep = TS.make_recsys_train_step(tcfg, topt)
            jstep = jax.jit(JS.make_recsys_train_step(jcfg, jopt))
            t_p, j_p = tp, jp
            single["losses"], ref["losses"] = [], []
            for b in train:
                t_p, ts, tm = tstep(t_p, ts, _torch(b))
                j_p, js, jm = jstep(j_p, js, _jax(b))
                single["losses"].append(float(tm["loss"]))
                ref["losses"].append(float(jm["loss"]))
            single.update(params=t_p, mu=ts.mu, nu=ts.nu)
            ref.update(params=j_p, mu=js.mu, nu=js.nu)
            oracles[arch] = (single, ref)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    _end_world(procs, WORLD_TIMEOUT)
    return torch.load(tmp / "out.pt", weights_only=False), oracles


def _np_leaves(t):
    """A port or reference tree's leaves as fp32 numpy, in ``jax.tree``
    order (the port's ``tree.leaves`` keeps it)."""
    if any(isinstance(x, jax.Array) for x in jax.tree.leaves(t)):
        return [np.asarray(x, np.float32) for x in jax.tree.leaves(t)]
    return [x.detach().float().numpy() for x in tree.leaves(t)]


def _compare_trees(got, want, what, leaf_scale=False):
    """Leaf by leaf; ``leaf_scale``: atol times the leaf's largest
    magnitude (Adam's moments)."""
    g, w = _np_leaves(got), _np_leaves(want)
    assert len(g) == len(w), what
    for k, (a, b) in enumerate(zip(g, w)):
        atol = TOL["atol"] * (float(np.abs(b).max(initial=0.0))
                              if leaf_scale else 1.0)
        np.testing.assert_allclose(a, b, rtol=TOL["rtol"], atol=atol,
                                   err_msg=f"{what} leaf {k}")


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_ranked_steps_match_single_device(world, case):
    got_all, oracles = world
    arch, layout, retrieval = case
    got = got_all[(arch, layout)]
    single, ref = oracles[arch]
    np.testing.assert_allclose(got["logits"].numpy(),
                               single["logits"].numpy(), **TOL)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(ref["logits"]), **TOL)
    np.testing.assert_allclose(got["losses"], single["losses"], **TOL)
    np.testing.assert_allclose(got["losses"], ref["losses"], **TOL)
    _compare_trees(got["params"], single["params"], f"{case} params")
    _compare_trees(got["params"], ref["params"], f"{case} params vs jax")
    for k in ("mu", "nu"):
        _compare_trees(got[k], single[k], f"{case} {k}", leaf_scale=True)
        _compare_trees(got[k], ref[k], f"{case} {k} vs jax",
                       leaf_scale=True)
    if retrieval:
        np.testing.assert_allclose(got["scores"].numpy(),
                                   single["scores"].numpy(), **TOL)
        np.testing.assert_allclose(got["scores"].numpy(),
                                   np.asarray(ref["scores"]), **TOL)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_ranked_table_layout(world, case):
    """The table sharded by rows as the rules say; the step's gradient,
    the moments and the updated value laid out as it is; every rank holds
    its block of the whole table; every rank reduced its bags through
    ``mesh_psum`` over the rows' ways; ``collectives.local_as`` (the
    staged layout ranks sharing a card take) gives DTensor's own layout
    of every gradient leaf."""
    got = world[0][(case[0], case[1])]
    want = {"model": [["Replicate", None], ["Shard", 0]],
            "dp_model": [["Shard", 0], ["Shard", 0]],
            "card": [["Replicate", None], ["Shard", 0]]}[case[1]]
    pl = got["placements"]
    assert pl["table"] == want
    assert pl["grad"] == pl["mu"] == pl["nu"] == pl["new"] == want
    # before the step's reduction: a partial sum over the batch's dim the
    # rows do not shard (each data rank bags its own part of the batch)
    raw = {"model": [["Partial", None], ["Shard", 0]]}.get(case[1], want)
    assert pl["raw_grad"] == raw
    ways = {"model": 2, "dp_model": 4, "card": 4}[case[1]]
    for r in got["ranks"]:
        assert r["local_ok"]
        assert r["psum_ways"] and set(r["psum_ways"]) == {ways}
        # collectives.local_as lays every gradient leaf out as DTensor's
        # redistribute does (within the order of a two-dim sum)
        assert r["staged_err"] <= 1e-7


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------
def test_column_sharded_table_raises():
    """A table sharded by columns is refused with a clear error; the
    route never gathers it by itself."""
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.launch import mesh as M
    with tcoll.fake_world(2):
        mesh = M.make_mesh((2,), ("model",), "cpu")
        table = DTensor.from_local(torch.zeros(8, 2), mesh, [Shard(1)],
                                   run_check=False)
        idx = torch.zeros(3, dtype=torch.int32)
        off = torch.tensor([0, 1, 3], dtype=torch.int32)
        with pytest.raises(ValueError, match="sharded by rows"):
            tops.embedding_bag(table, idx, off)
