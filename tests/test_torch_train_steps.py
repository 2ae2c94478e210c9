"""Port vs reference: the LM and recsys train steps (``train/steps.py``)
and the plain gradient of the embedding bag.

JAX parameters and optimizer states are carried into the port
(``convert.params_from_numpy``, ``convert.opt_state_from_numpy``), the
same numpy batches go to both, and one or two steps of the port's
``make_lm_train_step`` / ``make_recsys_train_step`` are held against the
jitted reference steps:

* every registry LM's ``reduced_config`` (dense, MoE, local/global) in
  fp32 with 1 and 2 microbatches: loss within 1e-5, ``grad_norm``
  within 1e-4 relative, parameters within 1e-5 and both moments within
  1e-5 of each leaf's largest value (XLA and torch sum in other
  orders); bf16 within the looser ``BF16_TOL`` (bf16 rounds at other places in the two frameworks);
* remat on and off give the same bits in the port;
* the four recsys archs at ``reduced_config``, loss within 1e-5 and
  parameters and moments as above (tables included: their gradient
  is the bag's backward, here its plain version through autograd);
* the bag's plain backward (``ref.embedding_bag_backward_ref``) and the
  autograd gradient through ``ops.embedding_bag`` against ``jax.grad``
  of the reference lookup and bag (``src/repro/models/recsys.py:49-70``):
  clipped and out-of-vocabulary ids, ``mean``, empty bags, and ids
  outside every bag.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import recsys as JR
from repro.train import steps as JS
from repro.train.optimizer import AdamW as JAdamW
from repro_torch.configs import registry as treg
from repro_torch.core import convert
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import recsys as TR
from repro_torch.train import steps as TS
from repro_torch.train import tree
from repro_torch.train.optimizer import AdamW as TAdamW

LM_ARCHS = ["tinyllama-1.1b", "gemma3-12b", "deepseek-coder-33b",
            "qwen2-moe-a2.7b", "grok-1-314b"]
RECSYS_ARCHS = ["xdeepfm", "dcn-v2", "dlrm-mlperf", "dien"]
# AdamW's default lr at full strength from step 1: Adam divides by
# sqrt(v), so an element whose gradient is near eps (1e-8) and differs in
# its last digits between XLA and torch moves by a part of lr (1.1e-5 at
# lr = 1e-3 once in Qwen2-MoE's wq)
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10)
TOL = dict(rtol=1e-5, atol=1e-5)
GNORM_RTOL = 1e-4
BF16_TOL = dict(rtol=2e-2, atol=2e-2)   # bf16 parameters after 2 steps
BF16_LOSS = 2e-2


def _np(tree_):
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree_)


def _compare(jtree, ttree, tol, what, leaf_scale=False):
    """Leaf by leaf; ``leaf_scale``: ``atol`` times the leaf's largest
    |reference| (Adam's moments: nu is about 0.05 g^2 after one step, far
    below any fixed atol on most entries)."""
    jl = jax.tree_util.tree_flatten_with_path(_np(jtree))[0]
    tl = list(tree.items_with_path(convert.params_to_numpy(ttree)))
    assert len(jl) == len(tl), what
    for (jp, j), (tp, t) in zip(jl, tl):
        atol = tol["atol"] * (float(np.abs(j).max(initial=0.0))
                              if leaf_scale else 1.0)
        np.testing.assert_allclose(t, j, rtol=tol["rtol"], atol=atol,
                                   err_msg=f"{what} {tp}")


def _run_lm(arch, n_micro, dtype="float32", steps=2):
    jcfg = dataclasses.replace(jreg.reduced_config(arch), param_dtype=dtype,
                               compute_dtype=dtype)
    tcfg = dataclasses.replace(treg.reduced_config(arch), param_dtype=dtype,
                               compute_dtype=dtype)
    jp = JS.init_params_for(jreg.get(arch), jcfg, jax.random.key(0))
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                      "cpu")
    jopt, topt = JAdamW(**OPT), TAdamW(**OPT)
    js, ts = jopt.init(jp), topt.init(tp)
    jstep = jax.jit(JS.make_lm_train_step(jcfg, jopt, n_microbatches=n_micro,
                                          q_chunk=8))
    tstep = TS.make_lm_train_step(tcfg, topt, n_microbatches=n_micro,
                                  q_chunk=8)
    rng = np.random.default_rng(7)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, jcfg.vocab, (4, 16), dtype=np.int32)
        jp, js, jm = jstep(jp, js, jnp.asarray(toks))
        tp, ts, tm = tstep(tp, ts, torch.as_tensor(toks))
        out.append((jm, tm))
    return (jp, js), (tp, ts), out


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_step_matches_reference(arch, n_micro):
    (jp, js), (tp, ts), metrics = _run_lm(arch, n_micro)
    for jm, tm in metrics:
        assert set(tm) == {"loss", "grad_norm"}
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=TOL["rtol"], atol=TOL["atol"])
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=GNORM_RTOL)
    assert int(ts.step) == int(js.step) == 2 and ts.step.dtype == torch.int32
    _compare(jp, tp, TOL, f"{arch} params")
    _compare(js.mu, ts.mu, TOL, f"{arch} mu",
             leaf_scale=True)
    _compare(js.nu, ts.nu, TOL, f"{arch} nu",
             leaf_scale=True)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b"])
def test_lm_train_step_bf16(arch):
    (jp, js), (tp, ts), metrics = _run_lm(arch, 2, dtype="bfloat16")
    for jm, tm in metrics:
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=BF16_LOSS)
    assert ts.mu["embed"].dtype == torch.bfloat16
    _compare(jp, tp, BF16_TOL, f"{arch} bf16 params")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma3-12b",
                                  "qwen2-moe-a2.7b"])
def test_remat_is_bit_equal(arch):
    """``cfg.remat`` recomputes each block in the backward: the same
    loss, gradients and update, bit for bit."""
    cfg = treg.reduced_config(arch)
    params = TS.init_params_for(treg.get(arch), cfg, seed=0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 16), dtype=np.int32))
    outs = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        opt = TAdamW(**OPT)
        step = TS.make_lm_train_step(c, opt, n_microbatches=2, q_chunk=8)
        outs.append(step(params, opt.init(params), toks))
    (p0, s0, m0), (p1, s1, m1) = outs
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    for a, b in zip(tree.leaves((p0, s0)), tree.leaves((p1, s1))):
        assert torch.equal(a, b)


def _recsys_batch(cfg, n, rng):
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


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_train_step_matches_reference(arch):
    jcfg, tcfg = jreg.reduced_config(arch), treg.reduced_config(arch)
    jp = JS.init_params_for(jreg.get(arch), jcfg, jax.random.PRNGKey(0))
    tp = convert.recsys_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                          "cpu")
    jopt, topt = JAdamW(**OPT), TAdamW(**OPT)
    js, ts = jopt.init(jp), topt.init(tp)
    n_micro = 2 if arch == "dcn-v2" else 1
    jstep = jax.jit(JS.make_recsys_train_step(jcfg, jopt, n_micro))
    tstep = TS.make_recsys_train_step(tcfg, topt, n_micro)
    rng = np.random.default_rng(11)
    for _ in range(2):
        b = _recsys_batch(jcfg, 32, rng)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.as_tensor(v)
                                    for k, v in b.items()})
        assert set(tm) == {"loss"}
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **TOL)
    _compare(jp, tp, TOL, f"{arch} params")
    _compare(js.mu, ts.mu, TOL, f"{arch} mu",
             leaf_scale=True)
    _compare(js.nu, ts.nu, TOL, f"{arch} nu",
             leaf_scale=True)


def test_bce_loss_matches_reference():
    rng = np.random.default_rng(2)
    logits = np.concatenate([rng.normal(size=60) * 8, [0.0, 0.0, 40, -40]]
                            ).astype(np.float32)
    labels = rng.integers(0, 2, 64).astype(np.float32)
    jl, jg = jax.value_and_grad(JR.bce_loss)(jnp.asarray(logits),
                                             jnp.asarray(labels))
    t = torch.as_tensor(logits).requires_grad_(True)
    tl = TR.bce_loss(t, torch.as_tensor(labels))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-9)


# ---------------------------------------------------------------------------
# The bag's gradient
# ---------------------------------------------------------------------------
def _csr_case(rng, R, B, max_len, lo_pad, hi_pad):
    """Random CSR bags (empty ones too) with ``lo_pad`` positions before
    the first bag and ``hi_pad`` after the last, and ids out of range."""
    lens = rng.integers(0, max_len + 1, B)
    lens[rng.random(B) < 0.2] = 0
    offsets = np.concatenate([[0], np.cumsum(lens)]) + lo_pad
    n = int(offsets[-1]) + hi_pad
    idx = rng.integers(-3, R + 3, n).astype(np.int32)
    return idx, offsets.astype(np.int32)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("D", [1, 10, 16])
def test_bag_backward_matches_jax_grad(mode, D):
    """Row r gets every in-bag position whose clipped id is r; the
    reference's bag is ``take(clip)`` + ``segment_sum`` with positions
    outside every bag given segment ids past ``num_bags``."""
    rng = np.random.default_rng(D)
    R, B = 50, 24
    idx, off = _csr_case(rng, R, B, 6, lo_pad=3, hi_pad=4)
    n = idx.shape[0]
    pos = np.arange(n)
    seg = np.searchsorted(off[1:], pos, side="right")
    seg = np.where((pos >= off[0]) & (pos < off[-1]), seg, B + 5)
    table = rng.normal(size=(R, D)).astype(np.float32)
    g = rng.normal(size=(B, D)).astype(np.float32)

    def jbag(t):
        rows = jnp.clip(jnp.asarray(idx), 0, R - 1)
        return JR.embedding_bag(t, rows, jnp.asarray(seg, jnp.int32), B,
                                mode)

    want = jax.grad(lambda t: jnp.sum(jbag(t) * g))(jnp.asarray(table))
    got = tref.embedding_bag_backward_ref(
        torch.as_tensor(g), torch.as_tensor(idx), torch.as_tensor(off),
        mode, R, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # the same through autograd over ops.embedding_bag (the CPU route)
    t = torch.as_tensor(table).requires_grad_(True)
    (tops.embedding_bag(t, torch.as_tensor(idx), torch.as_tensor(off), mode)
     * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # the routed plain backward, and bf16: an fp32 sum cast once
    np.testing.assert_array_equal(tops.embedding_bag_backward(
        torch.as_tensor(g), torch.as_tensor(idx), torch.as_tensor(off),
        mode, R, torch.float32).numpy(), got.numpy())
    assert torch.equal(tref.embedding_bag_backward_ref(
        torch.as_tensor(g), torch.as_tensor(idx), torch.as_tensor(off),
        mode, R, torch.bfloat16), got.to(torch.bfloat16))


def test_lookup_gradient_with_oov_ids_matches_jax_grad():
    """``embedding_lookup`` clips the flattened id to the padded table
    (the OOV quirk: field f's OOV id reads, and trains, a row of field
    f + 1)."""
    cfg = treg.reduced_config("dcn-v2")
    rows = TR.padded_rows(cfg.total_rows)
    rng = np.random.default_rng(5)
    ids = np.stack([rng.integers(0, v, 16) for v in cfg.vocab_sizes],
                   1).astype(np.int32)
    ids[0, :] = np.asarray(cfg.vocab_sizes) + 2       # OOV in every field
    ids[1, -1] = 10 ** 6                              # past the padded table
    table = rng.normal(size=(rows, cfg.embed_dim)).astype(np.float32)
    g = rng.normal(size=(16, len(cfg.vocab_sizes), cfg.embed_dim)
                   ).astype(np.float32)
    joff = JR.field_offsets(cfg.vocab_sizes)
    want = jax.grad(lambda t: jnp.sum(JR.embedding_lookup(
        t, jnp.asarray(ids), joff) * g))(jnp.asarray(table))
    t = torch.as_tensor(table).requires_grad_(True)
    (TR.embedding_lookup(t, torch.as_tensor(ids),
                         TR.field_offsets(cfg.vocab_sizes, "cpu"))
     * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert float(t.grad[rows - 1].abs().sum()) > 0    # the clipped id's row
