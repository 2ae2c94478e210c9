"""Port vs reference: the LM forward, loss, prefill and decode
(``models/transformer.py``).

JAX parameters (``repro.models.transformer.init_lm``) are carried into
the port (``convert.lm_params_from_numpy``), so both packages run the
same weights on the same numpy tokens, in fp32, at each of the five
registry LMs' ``reduced_config`` (dense, Gemma3's local/global stack
with an 8-token window, MoE with capacity factor 8.0):

* ``chunked_attention`` with full and windowed masks and a q offset;
* ``block_forward`` with ``return_kv`` and ``kv_keep``;
* ``lm_forward``, ``lm_loss`` and ``lm_prefill`` (logits and every
  cache field) and decode step by step (logits and cache);
* decode past the window (the reference's
  ``test_gemma_ring_buffer_window_equivalence`` form) against the
  port's own forward and the reference's decode;
* the int8 KV cache against the reference's int8 decode (dense and
  local/global), against the exact decode as ``tests/test_kv_quant.py``
  checks it, and ``_quant_kv`` bit for bit;
* cache and parameter shapes of the full registry configs, built on
  the ``meta`` device and by ``jax.eval_shape`` (nothing allocated).

Tolerance: the reference's own for its LM paths, 2e-4 (rtol and atol).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import LMConfig as JLMConfig
from repro.models import transformer as JT
from repro_torch.configs import registry as treg
from repro_torch.configs.base import LMConfig as TLMConfig
from repro_torch.core import convert
from repro_torch.models import transformer as TT

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["tinyllama-1.1b", "gemma3-12b", "deepseek-coder-33b",
         "qwen2-moe-a2.7b", "grok-1-314b"]
FIELDS = ("k", "v", "k_loc", "v_loc", "k_sc", "v_sc", "k_loc_sc",
          "v_loc_sc")

_jforward = jax.jit(JT.lm_forward, static_argnums=(2, 3))
_jloss = jax.jit(JT.lm_loss, static_argnums=(2, 3))
_jprefill = jax.jit(JT.lm_prefill, static_argnums=(2, 3))
_jdecode = jax.jit(JT.lm_decode_step, static_argnums=4)


def _pair(jcfg, tcfg, seed=0):
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jp = JT.init_lm(jcfg, jax.random.key(seed))
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                      "cpu")
    return jp, tp


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    a = request.param
    jcfg, tcfg = jreg.reduced_config(a), treg.reduced_config(a)
    return (a, jcfg, tcfg) + _pair(jcfg, tcfg)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), **tol)


def _caches_close(tc, jc, tol=TOL):
    for f in FIELDS:
        j, t = getattr(jc, f), getattr(tc, f)
        assert (j is None) == (t is None), f
        if j is not None:
            assert tuple(t.shape) == j.shape, f
            assert str(t.dtype).split(".")[1] == str(j.dtype), f
            _close(t, j, tol)


@pytest.mark.parametrize("window,q_offset,S,T", [
    (0, 0, 32, 32), (8, 0, 32, 32), (5, 0, 24, 24), (0, 16, 16, 32),
    (8, 16, 16, 32), (1, 0, 16, 16)])
def test_chunked_attention_matches_reference(window, q_offset, S, T):
    rng = np.random.default_rng(window * 7 + q_offset)
    q = rng.normal(size=(2, S, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, T, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, T, 2, 16)).astype(np.float32)
    want = JT.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), window=jnp.int32(window),
                                q_chunk=8, q_offset=q_offset)
    got = TT.chunked_attention(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v), window=window, q_chunk=8,
                               q_offset=q_offset)
    _close(got, want)


@pytest.mark.parametrize("kv_keep", [0, 8])
def test_block_forward_matches_reference(kv_keep):
    jcfg = jreg.reduced_config("gemma3-12b")
    tcfg = treg.reduced_config("gemma3-12b")
    jp, tp = _pair(jcfg, tcfg, seed=1)
    jl = jax.tree.map(lambda a: a[0], jp["local_layers"])
    tl = TT.cast_layer(TT.unbind_layers(tp["local_layers"])[0],
                       torch.float32)
    x = np.random.default_rng(2).normal(size=(2, 24, 64)).astype(np.float32)
    pos = np.tile(np.arange(24), (2, 1))
    jx, (jk, jv) = JT.block_forward(
        jl, jnp.asarray(x), jcfg, window=jnp.int32(8),
        positions=jnp.asarray(pos), q_chunk=8, return_kv=True,
        kv_keep=kv_keep)
    tx, (tk, tv) = TT.block_forward(
        tl, torch.as_tensor(x), tcfg, window=8,
        positions=torch.as_tensor(pos), q_chunk=8, return_kv=True,
        kv_keep=kv_keep)
    assert tk.shape == jk.shape == (2, kv_keep or 24, tcfg.n_kv_heads, 16)
    for t, j in ((tx, jx), (tk, jk), (tv, jv)):
        _close(t, j)
    _close(TT.block_forward(tl, torch.as_tensor(x), tcfg, window=0,
                            positions=torch.as_tensor(pos), q_chunk=8),
           JT.block_forward(jl, jnp.asarray(x), jcfg, window=jnp.int32(0),
                            positions=jnp.asarray(pos), q_chunk=8))


def test_forward_loss_prefill_match_reference(arch):
    _, jcfg, tcfg, jp, tp = arch
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 16),
                                             dtype=np.int32)
    tt = torch.as_tensor(toks)
    fwd = TT.lm_forward(tp, tt, tcfg, q_chunk=8)
    _close(fwd, _jforward(jp, jnp.asarray(toks), jcfg, 8))
    loss = TT.lm_loss(tp, tt, tcfg, q_chunk=8)
    _close(loss, _jloss(jp, jnp.asarray(toks), jcfg, 8))
    logits, cache = TT.lm_prefill(tp, tt, tcfg, q_chunk=8)
    jlogits, jcache = _jprefill(jp, jnp.asarray(toks), jcfg, 8)
    assert logits.dtype == torch.float32 and logits.shape == (2, jcfg.vocab)
    _close(logits, jlogits)
    _caches_close(cache, jcache)
    # the prefill's last logits are the forward's last row
    _close(logits, fwd[:, -1].numpy())


def test_decode_matches_reference(arch):
    """Decode 16 tokens from scratch: every step's logits and the final
    cache equal the reference's, and the last step equals the forward's
    last position (the reference's prefill/decode consistency check)."""
    _, jcfg, tcfg, jp, tp = arch
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 16),
                                             dtype=np.int32)
    jc = JT.init_decode_cache(jcfg, 2, 32)
    tc = TT.init_decode_cache(tcfg, 2, 32, device="cpu")
    _caches_close(tc, jc)
    for i in range(16):
        jl, jc = _jdecode(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                          jnp.int32(i), jcfg)
        tl, tc = TT.lm_decode_step(tp, tc, torch.as_tensor(toks[:, i:i + 1]),
                                   i, tcfg)
        _close(tl, jl)
    _caches_close(tc, jc)
    _close(tl, TT.lm_forward(tp, torch.as_tensor(toks), tcfg,
                             q_chunk=8)[:, -1].numpy())


def test_ring_buffer_decode_past_the_window():
    """Decode 3x the window (8): the ring cache equals the port's forward
    with sliding-window masking at every position, and the reference's
    ring decode step by step."""
    jcfg = jreg.reduced_config("gemma3-12b")
    tcfg = treg.reduced_config("gemma3-12b")
    jp, tp = _pair(jcfg, tcfg)
    S = 24
    toks = np.array(jax.random.randint(jax.random.PRNGKey(7), (1, S), 0,
                                        jcfg.vocab), np.int32)
    fwd = TT.lm_forward(tp, torch.as_tensor(toks), tcfg, q_chunk=8)
    jc = JT.init_decode_cache(jcfg, 1, S)
    tc = TT.init_decode_cache(tcfg, 1, S, device="cpu")
    assert tc.k_loc.shape == (1, 1, 8, tcfg.n_kv_heads, 16)
    assert tc.k.shape[2] == S
    for i in range(S):
        jl, jc = _jdecode(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                          jnp.int32(i), jcfg)
        tl, tc = TT.lm_decode_step(tp, tc, torch.as_tensor(toks[:, i:i + 1]),
                                   i, tcfg)
        _close(tl, jl)
        _close(tl, fwd[:, i].numpy())
    _caches_close(tc, jc)


def _int8_configs(kw):
    base = dict(name="t", n_layers=4, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab=64, remat=False, **kw)
    return (JLMConfig(**base), TLMConfig(**base),
            JLMConfig(**base, kv_quant=True), TLMConfig(**base, kv_quant=True))


@pytest.mark.parametrize("kw", [{}, dict(sliding_window=8,
                                         local_global_ratio=1)],
                         ids=["dense", "local_global"])
def test_int8_decode_matches_reference(kw):
    """The port's int8 decode against the reference's int8 decode (logits
    at every step, int8 values and scales of the final cache), and
    against the exact decode as tests/test_kv_quant.py checks it: max
    |dlogit| < 0.15, the last argmax equal, cache bytes < 0.6x."""
    jcfg, tcfg, jcq, tcq = _int8_configs(kw)
    jp, tp = _pair(jcfg, tcfg)
    toks = np.random.default_rng(0).integers(1, 64, (2, 12), dtype=np.int32)
    jc = JT.init_decode_cache(jcq, 2, 13)
    tc = TT.init_decode_cache(tcq, 2, 13, device="cpu")
    te = TT.init_decode_cache(tcfg, 2, 13, device="cpu")
    assert tc.k.dtype == torch.int8 and tc.k_sc.dtype == torch.float32
    errs = []
    for t in range(12):
        tok = toks[:, t:t + 1]
        jl, jc = _jdecode(jp, jc, jnp.asarray(tok), jnp.int32(t), jcq)
        tl, tc = TT.lm_decode_step(tp, tc, torch.as_tensor(tok), t, tcq)
        te_l, te = TT.lm_decode_step(tp, te, torch.as_tensor(tok), t, tcfg)
        _close(tl, jl)
        errs.append(float((tl - te_l).abs().max()))
    for f in FIELDS:
        j, t = getattr(jc, f), getattr(tc, f)
        if j is None:
            assert t is None
        elif t.dtype == torch.int8:
            # one level apart at most where a k/v rounds across a half
            assert int((t.int() - torch.as_tensor(np.array(j)).int())
                       .abs().max()) <= 1, f
        else:
            _close(t, j)
    assert max(errs) < 0.15
    assert torch.equal(tl.argmax(-1), te_l.argmax(-1))
    bytes_q = tc.k.nbytes + tc.k_sc.nbytes
    assert bytes_q < 0.6 * te.k.nbytes


@pytest.mark.parametrize("shape,dtype", [((4, 1, 2, 64), np.float32),
                                         ((3, 1, 8, 256), np.float32),
                                         ((2, 1, 2, 16), "bfloat16")])
def test_quant_kv_bit_equal(shape, dtype):
    """Same input: int8 values bit-equal, scales within 1 ulp; the
    round-trip error is at most half a scale (tests/test_kv_quant.py's
    bound)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    x[0, 0, 0, :3] = [0.5, -1.5, 2.5]        # halves: round to even
    jx = jnp.asarray(x, dtype)
    tx = convert._tensor(np.asarray(jx), "cpu")
    jq, js = JT._quant_kv(jx)
    tq, ts = TT._quant_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)
    back = tq.float() * ts[..., None]
    bound = tx.float().abs().amax(-1) / 254.0 + 1e-6
    assert bool(((back - tx.float()).abs() <= bound[..., None]).all())


@pytest.mark.parametrize("arch_name", ARCHS)
def test_full_config_shapes_match_reference(arch_name, monkeypatch):
    """At the published widths, the parameter tree and the decode caches
    (exact and int8; prefill_32k's length) have the reference's shapes
    and dtypes, built on the ``meta`` device / by ``jax.eval_shape``."""
    jcfg, tcfg = jreg.get(arch_name).config, treg.get(arch_name).config
    jtree = jax.eval_shape(lambda: JT.init_lm(jcfg, jax.random.key(0)))
    ttree = _meta_init(tcfg, monkeypatch)
    fj = jax.tree_util.tree_flatten_with_path(jtree)[0]
    ft = jax.tree_util.tree_flatten_with_path(ttree)[0]
    assert [p for p, _ in fj] == [p for p, _ in ft]
    for (path, j), (_, t) in zip(fj, ft):
        assert (tuple(t.shape), str(t.dtype).split(".")[1]) == \
            (j.shape, str(j.dtype)), path
    for quant in (False, True):
        jc_cfg = dataclasses.replace(jcfg, kv_quant=quant)
        tc_cfg = dataclasses.replace(tcfg, kv_quant=quant)
        jc = jax.eval_shape(lambda: JT.init_decode_cache(jc_cfg, 1, 32768))
        tc = TT.init_decode_cache(tc_cfg, 1, 32768, device="meta")
        for f in FIELDS:
            j, t = getattr(jc, f), getattr(tc, f)
            assert (j is None) == (t is None), f
            if j is not None:
                assert (tuple(t.shape), str(t.dtype).split(".")[1]) == \
                    (j.shape, str(j.dtype)), f


class _MetaGen:
    """Stands in for a ``torch.Generator`` on the ``meta`` device."""
    device = torch.device("meta")


def _meta_init(cfg, monkeypatch):
    """The port's ``init_lm`` tree of ``cfg`` with shapes and dtypes only:
    every draw an empty ``meta`` tensor."""
    monkeypatch.setattr(TT.L, "dense_init", lambda gen, shape, dtype,
                        scale=None: torch.empty(shape, dtype=dtype,
                                                device="meta"))
    return TT._init_tree(cfg, _MetaGen())


def test_paged_server_refuses_moe_and_local_global():
    from repro_torch.core.pointers import PoolLayout
    from repro_torch.paged import serve_model as TSM
    layout = PoolLayout(z=(6, 7, 8), slices_per_pool=(32, 16, 8))
    for a in ("qwen2-moe-a2.7b", "grok-1-314b", "gemma3-12b"):
        with pytest.raises(ValueError, match="dense, all-global"):
            TSM.make_server(treg.reduced_config(a), layout, 2, 64, "cpu")
    cfg = dataclasses.replace(treg.reduced_config("tinyllama-1.1b"),
                              kv_quant=True)
    assert TSM.make_server(cfg, layout, 2, 64, "cpu").cfg.kv_quant
