"""Port vs reference: the MoE FFN (``models/moe.py``).

A JAX layer (``repro.models.moe.init_moe_layer``) is carried into the
port (``convert.lm_params_from_numpy``; the router stays fp32), so both
packages route the same numpy tokens with the same weights, in fp32:

* the grouped ([G, T, d]) and token ([T, d]) paths, their outputs and
  both metrics, within the reference's own tolerance (1e-5);
* the port's grouped path against its token path group by group (the
  reference's ``tests/test_moe_grouped.py`` form);
* drops under imbalance (identical tokens, capacity factor 1.0) equal
  the reference's, output included, and none at capacity factor 8.0;
* ``moe_ep_pad``: padded experts are never routed to, against both the
  reference's padded layer and the port's unpadded one;
* the dispatch's slot maps are bit-equal to the reference's when the
  port's ``_dispatch`` is fed JAX's own ``expert``/``gate`` arrays
  (the reference's slot maps are read off its gather);
* routing ties go to the lower expert id, as ``lax.top_k`` orders them;
* the port's init has the reference's shapes, dtypes and scales.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LMConfig as JLMConfig
from repro.models import moe as JM
from repro_torch.configs.base import LMConfig as TLMConfig
from repro_torch.core import convert
from repro_torch.models import moe as TM

TOL = dict(rtol=1e-5, atol=1e-5)     # the reference's MoE tolerance
KW = dict(name="m", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
          d_ff=32, vocab=32, moe=True, n_experts=4, moe_top_k=2,
          n_shared_experts=1, moe_d_ff=16, capacity_factor=8.0)
JCFG, TCFG = JLMConfig(**KW), TLMConfig(**KW)

_jgrouped = jax.jit(JM._moe_ffn_grouped, static_argnums=2)
_jtokens = jax.jit(JM._moe_ffn_tokens, static_argnums=2)


def _port(tree, cfg=TCFG):
    return convert.lm_params_from_numpy(jax.tree.map(np.asarray, tree),
                                        cfg, "cpu")


@pytest.fixture(scope="module")
def layers():
    j = JM.init_moe_layer(JCFG, jax.random.key(0))
    return j, _port(j)


def _check(got, want, tol=TOL):
    y, m = got
    jy, jm = want
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **tol)
    for k in ("aux_loss", "drop_fraction"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **tol)


@pytest.mark.parametrize("shape", [(3, 8), (2, 16), (1, 64), (24,), (64,)],
                         ids=lambda s: "x".join(map(str, s)))
def test_moe_ffn_matches_reference(layers, shape):
    jl, tl = layers
    x = np.random.default_rng(len(shape) * 100 + shape[0]).normal(
        size=shape + (16,)).astype(np.float32)
    got = TM.moe_ffn(torch.as_tensor(x), tl, TCFG)
    fn = _jgrouped if len(shape) == 2 else _jtokens
    _check(got, fn(jnp.asarray(x), jl, JCFG))
    assert got[0].dtype == torch.float32 and got[0].shape == x.shape


def test_grouped_equals_per_group_tokens(layers):
    _, tl = layers
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(3, 8, 16)).astype(np.float32))
    y, m = TM.moe_ffn(x, tl, TCFG)
    for g in range(3):
        want, _ = TM._moe_ffn_tokens(x[g], tl, TCFG)
        np.testing.assert_allclose(y[g].numpy(), want.numpy(), **TOL)
    assert float(m["drop_fraction"]) == 0.0
    assert np.isfinite(float(m["aux_loss"]))


@pytest.mark.parametrize("cf", [1.0, 1.25, 8.0])
def test_drops_under_imbalance_match_reference(layers, cf):
    """Identical tokens all route the same way: at cf 1.0 most pairs
    drop (2 experts x C = 32 kept of 128), as in the reference."""
    jl, tl = layers
    jc, tc = (dataclasses.replace(c, capacity_factor=cf)
              for c in (JCFG, TCFG))
    x = np.ones((1, 64, 16), np.float32)
    got = TM.moe_ffn(torch.as_tensor(x), tl, tc)
    want = _jgrouped(jnp.asarray(x), jl, jc)
    _check(got, want)
    drop = float(got[1]["drop_fraction"])
    assert drop == float(want[1]["drop_fraction"])
    assert (drop >= 0.5) if cf == 1.0 else (drop == 0.0 if cf == 8.0
                                            else drop > 0)


def test_ep_padding_equivalent():
    """Padded experts (``moe_ep_pad``) are masked out of routing and never
    receive tokens: the port's padded layer equals the reference's padded
    layer and the port's unpadded one."""
    jcp = dataclasses.replace(JCFG, moe_ep_pad=8, n_experts=6,
                              n_shared_experts=0)
    tcp = dataclasses.replace(TCFG, moe_ep_pad=8, n_experts=6,
                              n_shared_experts=0)
    tcu = dataclasses.replace(tcp, moe_ep_pad=0)
    jl = JM.init_moe_layer(jcp, jax.random.key(3))
    tl = _port(jl, tcp)
    assert tl["router"].shape == (16, 8)
    assert tl["experts"]["w_gate"].shape == (8, 16, 16)
    tu = {"router": tl["router"][:, :6],
          "experts": {k: v[:6] for k, v in tl["experts"].items()}}
    x = np.random.default_rng(5).normal(size=(2, 8, 16)).astype(np.float32)
    yp = TM.moe_ffn(torch.as_tensor(x), tl, tcp)
    _check(yp, _jgrouped(jnp.asarray(x), jl, jcp))
    yu, _ = TM.moe_ffn(torch.as_tensor(x), tu, tcu)
    np.testing.assert_allclose(yp[0].numpy(), yu.numpy(), **TOL)


class _TakeSpy:
    """``jax.numpy`` with the reference's fill-mode gathers recorded: the
    index of ``take_along_axis``/``take`` with ``mode="fill"`` is the
    reference's ``slot_tok``."""

    def __init__(self):
        self.slot_tok = None

    def __getattr__(self, name):
        return getattr(jnp, name)

    def take_along_axis(self, a, idx, axis, **kw):
        if kw.get("mode") == "fill":
            self.slot_tok = np.asarray(idx)[..., 0]
        return jnp.take_along_axis(a, idx, axis, **kw)

    def take(self, a, idx, **kw):
        if kw.get("mode") == "fill":
            self.slot_tok = np.asarray(idx)[None]
        return jnp.take(a, idx, **kw)


@pytest.mark.parametrize("cf,grouped", [(8.0, True), (1.0, True),
                                        (1.0, False), (1.25, False)])
def test_slot_maps_bit_equal_fed_jax_routing(layers, monkeypatch, cf,
                                             grouped):
    """The port's dispatch fed JAX's own top-k (``expert``, renormalised
    ``gate``) builds the reference's slot maps bit for bit: ``slot_tok``
    as the reference gathers with it, and each filled slot's gate the
    gate of that (token, expert) pair."""
    jl, _ = layers
    cfg = dataclasses.replace(JCFG, capacity_factor=cf)
    rng = np.random.default_rng(int(cf * 10) + grouped)
    x = rng.normal(size=(3, 32, 16)).astype(np.float32)
    x[:, ::2] = x[:, :1]                 # imbalance: half the tokens alike
    x = x if grouped else x[0]
    spy = _TakeSpy()
    monkeypatch.setattr(JM, "jnp", spy)
    JM.moe_ffn(jnp.asarray(x), jl, cfg)
    monkeypatch.undo()
    probs = jax.nn.softmax(jnp.asarray(x) @ jl["router"], axis=-1)
    gate, expert = jax.lax.top_k(probs, cfg.moe_top_k)
    gate = gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)
    expert, gate = np.array(expert), np.array(gate)
    if not grouped:
        expert, gate = expert[None], gate[None]
    T = expert.shape[1]
    C = JM._capacity(cfg, T)
    assert C == TM._capacity(cfg, T)
    slot_tok, slot_gate, keep = TM._dispatch(
        torch.as_tensor(expert).long(), torch.as_tensor(gate), C, 4)
    slot_tok, slot_gate = slot_tok.numpy(), slot_gate.numpy()
    np.testing.assert_array_equal(slot_tok, spy.slot_tok)
    want = np.zeros_like(slot_gate)
    for g, s in zip(*np.nonzero(slot_tok < T)):
        t = slot_tok[g, s]
        j = list(expert[g, t]).index(s // C)
        want[g, s] = gate[g, t, j]
    np.testing.assert_array_equal(slot_gate, want)
    assert int(keep.sum()) == int((slot_tok < T).sum())


def test_routing_ties_take_the_lower_expert():
    """Equal router logits: every token picks experts 0..k-1, as
    ``lax.top_k`` orders ties."""
    router = np.zeros((16, 4), np.float32)
    x = np.random.default_rng(0).normal(size=(5, 16)).astype(np.float32)
    _, gate, expert = TM._route(torch.as_tensor(x), torch.as_tensor(router),
                                TCFG)
    _, jexp = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x @ router)), 2)
    np.testing.assert_array_equal(expert.numpy(), np.asarray(jexp))
    np.testing.assert_array_equal(expert.numpy(), [[0, 1]] * 5)
    np.testing.assert_allclose(gate.numpy(), 0.5)


def test_init_matches_reference_shapes_and_scales():
    """Shapes and dtypes of the port's init equal the reference's (the
    router fp32 under bf16 params), and each weight's spread is its
    reference scale (w_down fe**-0.5)."""
    kw = dict(KW, d_model=64, moe_d_ff=256, n_experts=8, n_shared_experts=2,
              param_dtype="bfloat16")
    jl = jax.eval_shape(lambda: JM.init_moe_layer(JLMConfig(**kw),
                                                  jax.random.key(0)))
    gen = torch.Generator().manual_seed(0)
    tl = TM.init_moe_layer(TLMConfig(**kw), gen)
    flat_j = jax.tree_util.tree_flatten_with_path(jl)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(tl)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (path, j), (_, t) in zip(flat_j, flat_t):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).split(".")[1] == str(j.dtype), path
    assert tl["router"].dtype == torch.float32
    for w, fan in ((tl["router"], 64), (tl["experts"]["w_gate"], 64),
                   (tl["experts"]["w_down"], 256),
                   (tl["shared"]["w_down"], 512)):
        np.testing.assert_allclose(float(w.float().std()), fan ** -0.5,
                                   rtol=0.1)
