"""Port vs reference: AdamW, ``global_norm``, gradient compression and the
runtime tests of ``tests/test_train_runtime.py``, mirrored.

* AdamW's update on a state carried across (``convert``) with the same
  gradients: fp32 parameters and moments bit-equal to the reference's
  update run op by op (without the clip, whose norm XLA sums in another
  order) and within 1e-6 relative (or 1e-6 of lr) of it under
  ``jax.jit`` (XLA fuses multiply-adds), ``step`` equal; bf16 moments within one
  bf16 ulp; the clip and ``global_norm``
  (its leaves summed in ``jax.tree``'s order) within 1e-6 relative;
* the schedule at step 0, mid-warmup, the end of warmup, mid-decay and
  the end bit-equal to JAX's fp32 (jitted and not), and within 1e-6
  relative at every step (XLA's ``cos`` and torch's differ in the last
  bit, which ``1 + cos`` magnifies near the end of the decay);
* ``quantize_int8``'s ``q`` and ``scale`` bit-equal, ``CompressedAdamW``
  with bit-equal residuals and the update within 1e-6, ``compressed_psum`` over a stacked ``[S, ...]`` axis
  equal to the reference's under ``jax.vmap(axis_name=...)`` (the
  per-shard quantisation summed, times the largest scale);
* the reference's convergence, moment-dtype, round-trip and straggler
  tests, on the port (the straggler flags equal the reference's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compression as JC
from repro.train import elastic as JE
from repro.train import optimizer as JO
from repro_torch.core import convert
from repro_torch.dist import collectives
from repro_torch.train import compression as TC
from repro_torch.train import elastic as TE
from repro_torch.train import optimizer as TO
from repro_torch.train import tree

# 1e-6 relative, or 1e-6 of the largest lr (1e-2) absolute: Adam divides
# by sqrt(v), so a fused multiply-add's last bit in a small moment moves
# a parameter by a part of lr
REL = dict(rtol=1e-6, atol=1e-8)


def _tree(rng, dtype=np.float32):
    """A parameter-like tree: nested dicts, a list of dicts, odd shapes."""
    def a(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(dtype)
    return {"w": a(8, 5), "b": a(5, scale=1e-3), "emb": a(13, 4),
            "layers": [{"k": a(3, 3), "n": a(3)}, {"k": a(3, 3),
                                                    "n": a(3, scale=40)}]}


def _to_torch(t, dtype=None):
    return tree.tree_map(lambda x: torch.as_tensor(np.array(x), dtype=dtype),
                         t)


def _close(jt, tt, **tol):
    jl = jax.tree.leaves(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                      jt))
    tl = [x.float().numpy() for x in tree.leaves(tt)]
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        np.testing.assert_allclose(t, j, **tol)


@pytest.mark.parametrize("opt", [
    dict(),
    dict(lr=1e-2, warmup_steps=2, total_steps=8),
    dict(lr=1e-2, warmup_steps=2, total_steps=8, clip_norm=None),
    dict(lr=5e-3, warmup_steps=0, total_steps=5, clip_norm=0.5,
         weight_decay=0.0),
], ids=["default", "warmup", "no-clip", "tight-clip"])
def test_adamw_update_matches_reference(opt):
    """Op for op the reference's update: without the clip bit-equal to
    it run op by op; within ``REL`` of it under ``jax.jit`` (XLA fuses
    multiply-adds)."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jopt, topt = JO.AdamW(**opt), TO.AdamW(**opt)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    # two reference steps, then the state crosses over
    for _ in range(2):
        jp, js = jax.jit(jopt.update)(
            jax.tree.map(jnp.asarray, _tree(rng)), js, jp)
    tp = _to_torch(jax.tree.map(np.asarray, jp))
    ts = convert.opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert ts.step.dtype == torch.int32 and int(ts.step) == 2
    ep, es = jp, js
    for _ in range(3):
        g = _tree(rng)
        jp, js = jax.jit(jopt.update)(jax.tree.map(jnp.asarray, g), js, jp)
        ep, es = jopt.update(jax.tree.map(jnp.asarray, g), es, ep)
        tp, ts = topt.update(_to_torch(g), ts, tp)
    assert int(ts.step) == int(js.step) == int(es.step) == 5
    # without the clip no reduction enters the update (the norm's sum
    # order is XLA's or torch's)
    exact = dict(rtol=0, atol=0) if opt.get("clip_norm", 1) is None else REL
    for a, b in ((ep, tp), (es.mu, ts.mu), (es.nu, ts.nu)):
        _close(a, b, **exact)
    for a, b in ((jp, tp), (js.mu, ts.mu), (js.nu, ts.nu)):
        _close(a, b, **REL)
    back = convert.opt_state_to_numpy(ts)
    assert back["step"].dtype == np.int32 and int(back["step"]) == 5


def test_adamw_bf16_moments_within_one_ulp():
    rng = np.random.default_rng(1)
    opt = dict(lr=1e-2, warmup_steps=1, total_steps=6,
               moment_dtype="bfloat16")
    jopt, topt = JO.AdamW(**opt), TO.AdamW(**opt)
    params = _tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts.mu["w"].dtype == torch.bfloat16 and \
        js.mu["w"].dtype == jnp.bfloat16
    for _ in range(3):
        g = _tree(rng)
        jp, js = jax.jit(jopt.update)(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = topt.update(_to_torch(g), ts, tp)
    for jm, tm in ((js.mu, ts.mu), (js.nu, ts.nu)):
        for j, t in zip(jax.tree.leaves(jm), tree.leaves(tm)):
            jb = np.asarray(j).view(np.int16).astype(np.int32)
            tb = t.view(torch.int16).numpy().astype(np.int32)
            assert np.abs(jb - tb).max() <= 1
    _close(jp, tp, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("opt", [dict(), dict(lr=1e-3, warmup_steps=20,
                                              total_steps=60),
                                 dict(lr=0.05, warmup_steps=5,
                                      total_steps=400)])
def test_schedule_matches_reference(opt):
    jopt, topt = JO.AdamW(**opt), TO.AdamW(**opt)
    w, T = jopt.warmup_steps, jopt.total_steps
    jit = jax.jit(jopt.schedule)
    for s in (0, w // 2, w, w + (T - w) // 2, T):
        want = np.float32(jit(jnp.int32(s)))
        got = topt.schedule(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert np.float32(got.item()) == want == np.float32(
            jopt.schedule(jnp.int32(s))), s
    steps = np.arange(0, T + 1, max(1, T // 97))
    got = np.asarray([topt.schedule(torch.tensor(int(s))).item()
                      for s in steps], np.float32)
    want = np.asarray([jit(jnp.int32(s)) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(2)
    g = _tree(rng)
    want = float(JO.global_norm(jax.tree.map(jnp.asarray, g)))
    got = TO.global_norm(_to_torch(g))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    # bf16 gradients are widened before squaring
    gb = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), g)
    np.testing.assert_allclose(
        float(TO.global_norm(_to_torch(g, torch.bfloat16))),
        float(JO.global_norm(gb)), rtol=1e-6)
    # the clip: a norm far over clip_norm scales the first moment
    big = jax.tree.map(lambda x: x * 1e3, g)
    opt = dict(lr=1e-2, warmup_steps=1, clip_norm=1.0)
    jp = jax.tree.map(jnp.asarray, g)
    _, js = JO.AdamW(**opt).update(jax.tree.map(jnp.asarray, big),
                                   JO.AdamW(**opt).init(jp), jp)
    tp = _to_torch(g)
    _, ts = TO.AdamW(**opt).update(_to_torch(big), TO.AdamW(**opt).init(tp),
                                   tp)
    _close(js.mu, ts.mu, **REL)
    norm = float(TO.global_norm(ts.mu))
    np.testing.assert_allclose(norm, 0.1, rtol=1e-5)   # (1 - b1) * 1.0


def test_quantize_int8_bit_equal():
    rng = np.random.default_rng(3)
    for x in (rng.normal(size=1000), rng.normal(size=(7, 9)) * 1e-3,
              np.zeros(5), np.asarray([0.5, -0.5, 1.5, 127.5, -2.5]),
              np.arange(-300, 300) / 2.0):
        x = x.astype(np.float32)
        jq, js = JC.quantize_int8(jnp.asarray(x))
        tq, ts = TC.quantize_int8(torch.as_tensor(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert np.float32(ts.item()) == np.float32(js)
        np.testing.assert_array_equal(
            TC.dequantize_int8(tq, ts).numpy(),
            np.asarray(JC.dequantize_int8(jq, js)))


def test_compressed_adamw_matches_reference():
    rng = np.random.default_rng(4)
    inner = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    jopt = JC.CompressedAdamW(JO.AdamW(**inner))
    topt = TC.CompressedAdamW(TO.AdamW(**inner))
    params = _tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    js = jopt.init(jp)
    ts = convert.opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert isinstance(ts, TC.CompressedState)
    ep, es = jp, js
    for _ in range(4):
        g = _tree(rng)
        jp, js = jax.jit(jopt.update)(jax.tree.map(jnp.asarray, g), js, jp)
        ep, es = jopt.update(jax.tree.map(jnp.asarray, g), es, ep)
        tp, ts = topt.update(_to_torch(g), ts, tp)
    _close(es.residual, ts.residual, rtol=0, atol=0)   # no reduction
    for a, b in ((ep, tp), (es.inner.mu, ts.inner.mu)):
        _close(a, b, **REL)
    _close(jp, tp, **REL)
    _close(js.inner.mu, ts.inner.mu, **REL)
    assert int(ts.inner.step) == 4


def test_compressed_psum_matches_reference():
    rng = np.random.default_rng(5)
    S = 4
    x = {"a": rng.normal(size=(S, 6, 3)).astype(np.float32),
         "b": [(rng.normal(size=(S, 10)) * 10.0 ** np.arange(S)[:, None]
                ).astype(np.float32)]}
    want = jax.vmap(lambda t: JC.compressed_psum(t, "i"), axis_name="i")(
        jax.tree.map(jnp.asarray, x))
    got = TC.compressed_psum(_to_torch(x))
    for w, g, xs in zip(jax.tree.leaves(want), tree.leaves(got),
                        jax.tree.leaves(x)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[0])
        # the per-shard quantisation summed, times the largest scale
        qs = [JC.quantize_int8(jnp.asarray(xs[s])) for s in range(S)]
        acc = sum(np.asarray(q, np.int32) for q, _ in qs)
        scale = max(np.float32(s) for _, s in qs)
        np.testing.assert_array_equal(g.numpy(), acc.astype(np.float32)
                                      * scale)
    m = torch.as_tensor(rng.normal(size=(S, 5)).astype(np.float32))
    assert torch.equal(collectives.pmax(m), m.max(0).values)


# ---------------------------------------------------------------------------
# tests/test_train_runtime.py, on the port
# ---------------------------------------------------------------------------
def _quadratic_problem():
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.normal(size=(64, 8)), dtype=torch.float32)
    w_true = torch.as_tensor(rng.normal(size=(8,)), dtype=torch.float32)
    y = X @ w_true

    def loss_fn(params, _batch=None):
        return torch.mean((X @ params["w"] - y) ** 2)

    return loss_fn, {"w": torch.zeros(8)}


def _grad(loss_fn, params):
    w = params["w"].detach().requires_grad_(True)
    (g,) = torch.autograd.grad(loss_fn({"w": w}), [w])
    return {"w": g}


def test_adamw_converges():
    loss_fn, params = _quadratic_problem()
    opt = TO.AdamW(lr=0.05, warmup_steps=5, total_steps=400,
                   weight_decay=0.0)
    state = opt.init(params)
    for _ in range(400):
        params, state = opt.update(_grad(loss_fn, params), state, params)
    assert float(loss_fn(params)) < 1e-3


def test_adamw_moment_dtype():
    _, params = _quadratic_problem()
    st = TO.AdamW(moment_dtype="bfloat16").init(params)
    assert st.mu["w"].dtype == torch.bfloat16


def test_compressed_adamw_converges_with_error_feedback():
    loss_fn, params = _quadratic_problem()
    opt = TC.CompressedAdamW(TO.AdamW(lr=0.05, warmup_steps=5,
                                      total_steps=600, weight_decay=0.0))
    state = opt.init(params)
    for _ in range(600):
        params, state = opt.update(_grad(loss_fn, params), state, params)
    assert float(loss_fn(params)) < 5e-3


def test_quantize_roundtrip_error_bounded():
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(1000,)),
                        dtype=torch.float32)
    q, s = TC.quantize_int8(x)
    err = (TC.dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-6


def test_straggler_watchdog_matches_reference():
    dts = [1.0, 1.0, 1.0, 5.0, 1.0, 1.1, 4.0, 0.2, 3.0, 0.9]
    jt = JE.StepTimer(alpha=0.5, straggler_factor=2.0)
    tt = TE.StepTimer(alpha=0.5, straggler_factor=2.0)
    flags = [tt.observe(dt) for dt in dts]
    assert flags == [jt.observe(dt) for dt in dts]
    assert flags[:7] == [False, False, False, True, False, False, True]
    assert tt.report() == jt.report()
    assert tt.report()["straggler_steps"][:2] == [4, 7]
