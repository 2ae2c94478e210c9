"""Port vs reference: the LM serving steps (``train/steps.py``), the LM
token pipeline (``data/lm_data.py``) and the per-arch config modules.

* ``make_lm_prefill_step`` and ``make_lm_decode_step`` against the
  reference's steps (jitted) at each registry LM's ``reduced_config``,
  with JAX weights carried across: prefill logits and cache, and a
  greedy decode fed its own tokens after the prompt (every next token
  equal, logits within the reference's 2e-4);
* ``init_params_for`` builds every LM arch with the reference's tree,
  shapes and dtypes;
* ``lm_data``: the Zipf CDF bit-equal to the reference's, the map from
  a uniform to a token bit-equal on the same uniforms (CDF values and
  their float neighbours included), batches a pure function of (seed,
  step) of the right shape, dtype and range;
* the five ``configs/<arch>.py`` modules' ``CONFIG`` equal the
  reference's.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import lm_data as JD
from repro.models import transformer as JT
from repro.train import steps as JS
from repro_torch.configs import registry as treg
from repro_torch.core import convert
from repro_torch.data import lm_data as TD
from repro_torch.models import transformer as TT
from repro_torch.train import steps as TS

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["tinyllama-1.1b", "gemma3-12b", "deepseek-coder-33b",
         "qwen2-moe-a2.7b", "grok-1-314b"]
MODULES = {"tinyllama-1.1b": "tinyllama_1b", "gemma3-12b": "gemma3_12b",
           "deepseek-coder-33b": "deepseek_coder_33b",
           "qwen2-moe-a2.7b": "qwen2_moe_a2_7b", "grok-1-314b": "grok_1_314b"}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_reference(arch):
    jcfg, tcfg = jreg.reduced_config(arch), treg.reduced_config(arch)
    jp = JS.init_params_for(jreg.get(arch), jcfg, jax.random.key(0))
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                      "cpu")
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 16),
                                             dtype=np.int32)
    jl, jc = jax.jit(JS.make_lm_prefill_step(jcfg, q_chunk=8))(
        jp, jnp.asarray(toks))
    tl, tc = TS.make_lm_prefill_step(tcfg, q_chunk=8)(tp,
                                                      torch.as_tensor(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for f in ("k", "v", "k_loc", "v_loc"):
        if getattr(jc, f) is not None:
            np.testing.assert_allclose(getattr(tc, f).numpy(),
                                       np.asarray(getattr(jc, f)), **TOL)
    jdec = jax.jit(JS.make_lm_decode_step(jcfg))
    tdec = TS.make_lm_decode_step(tcfg)
    jcache = JT.init_decode_cache(jcfg, 2, 24)
    tcache = TT.init_decode_cache(tcfg, 2, 24, device="cpu")
    tok = toks[:, :1]
    for i in range(22):
        feed = toks[:, i:i + 1] if i < 16 else tok
        jn, jlog, jcache = jdec(jp, jcache, jnp.asarray(feed), jnp.int32(i))
        tn, tlog, tcache = tdec(tp, tcache, torch.as_tensor(feed), i)
        assert tn.dtype == torch.int32 and tn.shape == (2, 1)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        if i == 15:    # the prompt's last step: the prefill's logits
            np.testing.assert_allclose(tlog.numpy(), tl.numpy(), **TOL)
        tok = tn.numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_for_builds_every_lm(arch):
    jcfg, tcfg = jreg.reduced_config(arch), treg.reduced_config(arch)
    jtree = jax.eval_shape(lambda: JS.init_params_for(
        jreg.get(arch), jcfg, jax.random.key(0)))
    ttree = TS.init_params_for(treg.get(arch), tcfg, seed=0, device="cpu")
    fj = jax.tree_util.tree_flatten_with_path(jtree)[0]
    ft = jax.tree_util.tree_flatten_with_path(ttree)[0]
    assert [p for p, _ in fj] == [p for p, _ in ft]
    for (path, j), (_, t) in zip(fj, ft):
        assert (tuple(t.shape), str(t.dtype).split(".")[1]) == \
            (j.shape, str(j.dtype)), path
    # the same seed draws the same weights; another seed other weights
    again = TS.init_params_for(treg.get(arch), tcfg, seed=0, device="cpu")
    other = TS.init_params_for(treg.get(arch), tcfg, seed=1, device="cpu")
    jax.tree.map(lambda a, b: torch.testing.assert_close(a, b, rtol=0,
                                                         atol=0),
                 ttree, again)
    assert not torch.equal(ttree["embed"], other["embed"])


@pytest.mark.parametrize("vocab,alpha", [(256, 1.0), (32000, 1.0),
                                         (1000, 1.3), (151936, 0.8)])
def test_zipf_cdf_and_token_map_match_reference(vocab, alpha):
    cdf = TD._zipf_cdf(vocab, alpha)
    np.testing.assert_array_equal(cdf, JD._zipf_cdf(vocab, alpha))
    jcdf = jnp.asarray(cdf, jnp.float32)
    tcdf = torch.as_tensor(cdf, dtype=torch.float32)
    np.testing.assert_array_equal(tcdf.numpy(), np.asarray(jcdf))
    rng = np.random.default_rng(vocab)
    c32 = np.asarray(jcdf)
    u = np.concatenate([
        rng.random(4096, dtype=np.float32), c32[:64], c32[-64:],
        np.nextafter(c32[:64], np.float32(0)),
        np.nextafter(c32[:64], np.float32(2)),
        np.asarray([0.0, 1.0, np.nextafter(np.float32(1), np.float32(0))],
                   np.float32)]).astype(np.float32)
    want = np.asarray(jnp.clip(jnp.searchsorted(jcdf, jnp.asarray(u))
                               .astype(jnp.int32), 0, vocab - 1))
    got = TD.tokens_from_uniform(tcdf, torch.as_tensor(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_batches_are_a_function_of_seed_and_step():
    cfg = TD.LMDataConfig(vocab=1000, batch=4, seq_len=64, seed=3)
    fn = TD.make_batch_fn(cfg, device="cpu")
    a, b = fn(7), fn(7)
    assert a.dtype == torch.int32 and a.shape == (4, 64)
    assert torch.equal(a, b)
    assert not torch.equal(a, fn(8))
    assert not torch.equal(
        a, TD.make_batch_fn(dataclasses.replace(cfg, seed=4), "cpu")(7))
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab
    got = list(TD.batches(cfg, 5, 3, device="cpu"))
    assert len(got) == 3 and torch.equal(got[2], a)
    # Zipf(1.0): token 0 is the most frequent, about 1 / H(1000) of all
    big = TD.make_batch_fn(dataclasses.replace(cfg, batch=64, seq_len=1024),
                           "cpu")(0)
    share = float((big == 0).float().mean())
    assert abs(share - 1 / np.sum(1 / np.arange(1, 1001))) < 0.01


@pytest.mark.parametrize("arch", ARCHS)
def test_config_modules_match_reference(arch):
    j = importlib.import_module(f"repro.configs.{MODULES[arch]}")
    t = importlib.import_module(f"repro_torch.configs.{MODULES[arch]}")
    assert dataclasses.asdict(t.CONFIG) == dataclasses.asdict(j.CONFIG)
    assert t.CONFIG == treg.get(arch).config
    assert t.__all__ == ["CONFIG"]
