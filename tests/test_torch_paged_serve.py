"""Port vs reference: paged-KV decoder serving.

JAX parameters (``repro.models.transformer.init_lm``) are carried into
the port (``convert.lm_params_from_numpy``), so both packages decode
with the same weights, in fp32:

* the port's paged ``decode_step`` logits match the JAX paged
  ``decode_step`` and the JAX dense ``lm_decode_step`` within 2e-4, and
  the port's dense ``lm_decode_step`` matches the JAX one likewise;
* ``prefill`` gives the same first tokens and lengths;
* the port's serving loop (``launch.serve.serve`` on the CPU) and a loop
  built from the JAX ``prefill``/``decode_step`` with the same seed
  generate the same tokens and end with the same lengths, watermark,
  C_M waste and mean chain hops.

Configs: the reduced TinyLlama (``reduced_config("tinyllama-1.1b")``)
and the JAX paged-serving test's ``CFG``.  The JAX decode attends
through its plain oracle ``paged_attention_ref`` here (the Pallas kernel
in interpret mode is held against it in ``test_torch_paged_attention``)
and runs jitted, which keeps the file fast.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import LMConfig as JLMConfig
from repro.core import analytical as janalytical
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.core.pointers import PoolLayout as JLayout
from repro.models import transformer as JT
from repro.paged import kv_cache as JP
from repro.paged import serve_model as JSM
from repro_torch.configs import registry as treg
from repro_torch.configs.base import LMConfig as TLMConfig
from repro_torch.core import convert
from repro_torch.core.pointers import PoolLayout as TLayout
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.paged import kv_cache as TP
from repro_torch.paged import serve_model as TSM

TOL = 2e-4
SMALL = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
             d_ff=64, vocab=64, remat=False)
Z, SPP = (6, 7, 8), (32, 16, 8)


@pytest.fixture(scope="module", autouse=True)
def jax_plain_attention_jitted():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jops, "paged_attention", jref.paged_attention_ref)
        mp.setattr(JSM, "decode_step",
                   jax.jit(JSM.decode_step, static_argnums=0))
        yield


_jdense = jax.jit(JT.lm_decode_step, static_argnums=4)


def _configs(which):
    if which == "tinyllama-smoke":
        return (jreg.reduced_config("tinyllama-1.1b"),
                treg.reduced_config("tinyllama-1.1b"))
    return JLMConfig(**SMALL), TLMConfig(**SMALL)


@pytest.fixture(scope="module", params=["tinyllama-smoke", "small"])
def model(request):
    jcfg, tcfg = _configs(request.param)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = JT.init_lm(jcfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, jparams)
    tparams = convert.lm_params_from_numpy(tree, tcfg, "cpu")
    back = convert.lm_params_to_numpy(tparams)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    return jcfg, tcfg, jparams, tparams


def test_bf16_params_carry_across():
    """A bf16 reference tree (numpy's ml_dtypes bfloat16) arrives as
    torch bfloat16 with the same bits, and comes back as exact float32."""
    jcfg, tcfg = (dataclasses.replace(c, param_dtype="bfloat16")
                  for c in _configs("small"))
    tree = jax.tree.map(np.asarray, JT.init_lm(jcfg, jax.random.key(3)))
    tparams = convert.lm_params_from_numpy(tree, tcfg, "cpu")
    assert tparams["layers"]["wq"].dtype == torch.bfloat16
    jax.tree.map(lambda got, want: np.testing.assert_array_equal(
        got, want.astype(np.float32)),
        convert.lm_params_to_numpy(tparams), tree)


def _servers(jcfg, tcfg, max_seqs=4, max_len=256):
    return (JSM.make_server(jcfg, JLayout(z=Z, slices_per_pool=SPP),
                            max_seqs=max_seqs, max_len=max_len),
            TSM.make_server(tcfg, TLayout(z=Z, slices_per_pool=SPP),
                            max_seqs, max_len, "cpu"))


def test_config_copies_agree():
    for arch in ("tinyllama-1.1b", "gemma3-12b", "deepseek-coder-33b",
                 "qwen2-moe-a2.7b", "grok-1-314b"):
        j, t = jreg.get(arch).config, treg.get(arch).config
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.param_count == t.param_count
        assert j.active_param_count == t.active_param_count
        assert dataclasses.asdict(jreg.reduced_config(arch)) == \
            dataclasses.asdict(treg.reduced_config(arch))
    # SchNet, the last config to cross, is the reference's too
    assert dataclasses.asdict(jreg.get("schnet").config) == \
        dataclasses.asdict(treg.get("schnet").config)
    # the reference's demo server runs dense LMs only (``assert not
    # cfg.moe``; Gemma3's stacks have no ``params["layers"]``)
    for arch in ("qwen2-moe-a2.7b", "gemma3-12b"):
        with pytest.raises(ValueError, match="dense, all-global"):
            TSM.make_server(treg.reduced_config(arch),
                            TLayout(z=Z, slices_per_pool=SPP), 2, 64, "cpu")


def test_decode_matches_reference_paged_and_dense(model):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(0)
    B, S = 3, 17
    toks = rng.integers(1, jcfg.vocab, (B, S)).astype(np.int32)
    jserver, tserver = _servers(jcfg, tcfg)
    jst = JP.init_kv_state(jserver.kv_cfg)
    tst = TP.init_kv_state(tserver.kv_cfg, "cpu")
    jcache = JT.init_decode_cache(jcfg, B, max_len=S + 1)
    tcache = TT.init_decode_cache(tcfg, B, max_len=S + 1, device="cpu")
    jids = jnp.arange(B, dtype=jnp.int32)
    tids = torch.arange(B)
    for t in range(S):
        _, jl, jst = JSM.decode_step(jserver, jparams, jst, jids,
                                     jnp.asarray(toks[:, t]))
        tn, tl, tst = TSM.decode_step(tserver, tparams, tst, tids,
                                      torch.as_tensor(toks[:, t]))
        jd, jcache = _jdense(jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t), jcfg)
        td, tcache = TT.lm_decode_step(tparams, tcache,
                                       torch.as_tensor(toks[:, t:t + 1]),
                                       t, tcfg)
        assert tl.dtype == torch.float32 and tn.dtype == torch.int32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jd), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(tn.numpy(),
                                      np.asarray(jnp.argmax(jl, -1)))
    for f in ("link", "watermark", "tail", "length", "overflow"):
        np.testing.assert_array_equal(
            convert.kv_state_to_numpy(tst)[f], np.asarray(getattr(jst, f)))
    np.testing.assert_allclose(convert.kv_state_to_numpy(tst)["k_heap"],
                               np.asarray(jst.k_heap), rtol=TOL, atol=TOL)


def test_prefill_same_first_tokens(model):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(2)
    prompt = rng.integers(1, jcfg.vocab, (3, 7)).astype(np.int32)
    plen = np.asarray([7, 3, 5])
    jserver, tserver = _servers(jcfg, tcfg)
    jn, jst = JSM.prefill(jserver, jparams, JP.init_kv_state(jserver.kv_cfg),
                          np.asarray([0, 2, 3]), prompt, plen)
    tn, tst = TSM.prefill(tserver, tparams,
                          TP.init_kv_state(tserver.kv_cfg, "cpu"),
                          np.asarray([0, 2, 3]), prompt, plen)
    np.testing.assert_array_equal(tn, np.asarray(jn))
    np.testing.assert_array_equal(tst.length.numpy(), np.asarray(jst.length))
    assert tst.length.tolist() == [7, 0, 3, 5]


def _reference_loop(cfg, params, z, requests, max_seqs, max_len, seed):
    """The request loop of the reference's ``launch/serve.py`` main, on
    its ``prefill``/``decode_step``, recording every generated token."""
    rng = np.random.default_rng(seed)
    per_seq = janalytical.slices_needed(z, np.asarray([max_len]))[0]
    spp = tuple(max(8, int(max_seqs * per_seq)) for _ in range(len(z)))
    server = JSM.make_server(cfg, JLayout(z=z, slices_per_pool=spp),
                             max_seqs, max_len)
    state = JP.init_kv_state(server.kv_cfg)
    p_len = np.clip(rng.zipf(1.5, requests) * 4, 4, 64)
    o_len = np.clip(rng.zipf(1.4, requests) * 8, 8, max_len - 80)
    queue, active, free = list(range(requests)), {}, list(range(max_seqs))
    done, generated = 0, {}
    while done < requests:
        while queue and free:
            r = queue.pop(0)
            slot = free.pop(0)
            prompt = rng.integers(1, cfg.vocab, size=(1, p_len[r]))
            nxt, state = JSM.prefill(server, params, state,
                                     np.asarray([slot]),
                                     prompt.astype(np.int32),
                                     np.asarray([p_len[r]]))
            active[slot] = [int(o_len[r]), int(np.asarray(nxt)[0]), r]
            generated[r] = [int(np.asarray(nxt)[0])]
        slots = sorted(active)
        nxt, _, state = JSM.decode_step(
            server, params, state, jnp.asarray(slots, jnp.int32),
            jnp.asarray([active[s][1] for s in slots], jnp.int32))
        nxt = np.asarray(nxt)
        for i, s in enumerate(slots):
            active[s][0] -= 1
            active[s][1] = int(nxt[i])
            generated[active[s][2]].append(int(nxt[i]))
            if active[s][0] <= 0:
                done += 1
                free.append(s)
                del active[s]
    lens = np.asarray(state.length)
    alloc = JP.kv_slots_allocated(server.kv_cfg, state)
    hops = janalytical.slices_needed(z, np.maximum(lens[lens > 0], 1))
    return dict(generated=generated, lengths=lens.tolist(),
                watermark=np.asarray(state.watermark).tolist(),
                cm_waste=(alloc - int(lens.sum())) / max(alloc, 1),
                mean_hops=float(hops.mean()),
                overflow=bool(state.overflow))


def test_serving_loop_matches_reference():
    """The reduced TinyLlama served on 2 slots, 4 requests (one slot is
    reused with its chain kept and outgrows max_len)."""
    jcfg, tcfg = _configs("tinyllama-smoke")
    jparams = JT.init_lm(jcfg, jax.random.key(1))
    tparams = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    z, kw = (6, 8, 10), dict(requests=4, max_seqs=2, max_len=320, seed=0)
    want = _reference_loop(jcfg, jparams, z, **kw)
    layout = tserve.kv_layout(z, kw["max_seqs"], kw["max_len"])
    got, _, _ = tserve.serve(tcfg, tparams, layout, device="cpu",
                             log=lambda *_: None, **kw)
    assert got["generated"] == want["generated"]
    for key in ("lengths", "watermark", "cm_waste", "mean_hops",
                "overflow"):
        assert got[key] == want[key], key
    assert got["outgrew_max_len"] == 1
    assert got["tokens"] == sum(len(g) - 1 for g in got["generated"].values()
                                ) + got["prefill_tokens"]
