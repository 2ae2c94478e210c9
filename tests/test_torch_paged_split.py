"""Port vs reference: the split design of the paged-attention kernel.

The CUDA kernel splits each row's pages across ``S`` CTAs of ``pps``
pages (``kernels.paged_attention.split_plan``, from shapes alone) and
merges their fp32 partials ``(m, l, acc)`` in split order.  Here, on
the CPU: the split rule covers every page and fills the card at the
registry's LM head shapes, and the plain mirror of the split-and-merge
(``kernels.ref.paged_attention_split_ref``) matches the JAX oracle
``repro.kernels.ref.paged_attention_ref`` at lengths 0, 1, at and next
to split boundaries and longer than the table, within the paged tests'
tolerances: 3e-5 in fp32, 2e-2 for bf16 inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.configs import registry
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref

PAGE = 64
H100_SMS = 132
LM_ARCHS = ("tinyllama-1.1b", "gemma3-12b", "deepseek-coder-33b",
            "qwen2-moe-a2.7b", "grok-1-314b")


def _heads(arch):
    cfg = registry.get(arch).config
    return cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head


@pytest.mark.parametrize("B", [1, 2, 7, 32, 256, 4096])
@pytest.mark.parametrize("NP", [1, 2, 3, 5, 32, 33, 100])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_split_plan_covers_every_page(B, NP, arch):
    Hkv, G, _ = _heads(arch)
    S, pps = tpa.split_plan(B, Hkv, G, NP, H100_SMS)
    assert 1 <= S <= min(NP, tpa.MAX_SPLITS) and pps >= 1
    assert S * pps >= NP                  # every page has a split
    assert (S - 1) * pps < NP             # and no split is empty by shape


@pytest.mark.parametrize("B", [1, 32])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma3-12b",
                                  "deepseek-coder-33b"])
def test_split_plan_fills_the_card(B, arch):
    """At least half the target of CTAS_PER_SM CTAs per SM, or one CTA
    per page when the table has fewer (TinyLlama at B = 1: 4 KV heads x
    32 pages), and never more than about the target."""
    Hkv, G, _ = _heads(arch)
    NP = 2048 // PAGE
    S, pps = tpa.split_plan(B, Hkv, G, NP, H100_SMS)
    units = B * Hkv * -(-G // tpa.HEADS)
    target = tpa.CTAS_PER_SM * H100_SMS
    assert units * S >= min(target // 2, units * NP)
    assert units * S <= max(target, units)


def _case(seed, B, Hkv, G, D, lens, NP, n_pages=96):
    rng = np.random.default_rng(seed)
    table = np.full((B, NP), -1, np.int32)
    perm = rng.permutation(n_pages)
    pi = 0
    for b, n in enumerate(lens):
        need = min(-(-n // PAGE), NP)
        table[b, :need] = perm[pi:pi + need]
        pi += need
    q = rng.normal(size=(B, Hkv, G, D)).astype(np.float32)
    kh = rng.normal(size=(Hkv, n_pages * PAGE, D)).astype(np.float32)
    vh = rng.normal(size=(Hkv, n_pages * PAGE, D)).astype(np.float32)
    return q, kh, vh, table, np.asarray(lens, np.int32)


def _split_vs_oracle(args, S, pps, dtype):
    q, kh, vh, table, lens = args
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, kh, vh))
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jdt) for t in (tq, tk, tv))
    got = tref.paged_attention_split_ref(tq, tk, tv, torch.from_numpy(table),
                                         torch.from_numpy(lens), S, pps)
    want = jref.paged_attention_ref(jq, jk, jv, jnp.asarray(table),
                                    jnp.asarray(lens))
    return got.numpy(), np.asarray(want)


NP_SMALL = 6


def _boundary_lens(pps):
    """0, 1, at and next to the split edges, and past the table."""
    edge = pps * PAGE
    return [0, 1, edge - 1, edge, edge + 1, 2 * edge, 2 * edge + 1,
            NP_SMALL * PAGE - 1, NP_SMALL * PAGE, NP_SMALL * PAGE + 100]


@pytest.mark.parametrize("dtype,tol", [("fp32", 3e-5), ("bf16", 2e-2)])
@pytest.mark.parametrize("pps", [1, 2, 3, 5])
def test_split_merge_matches_jax_oracle(pps, dtype, tol):
    lens = _boundary_lens(pps)
    S = -(-NP_SMALL // pps)
    args = _case(pps, len(lens), 2, 3, 16, lens, NP_SMALL)
    got, want = _split_vs_oracle(args, S, pps, dtype)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert not got[0].any()                       # length 0 gives 0


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 128, 129, 383, 384, 500])
@pytest.mark.parametrize("pps", [1, 2, 4])
def test_split_merge_at_batch_one(n, pps):
    """B = 1 (a prefill call): one row split into ceil(NP / pps) runs."""
    S = -(-NP_SMALL // pps)
    args = _case(n + pps, 1, 4, 8, 32, [n], NP_SMALL)
    got, want = _split_vs_oracle(args, S, pps, "fp32")
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_split_merge_at_registry_head_shapes(arch):
    """Every registry LM head shape (G in {1, 2, 6, 7, 8}, D in {64,
    128, 256}) under the split the rule picks for a full card."""
    Hkv, G, D = _heads(arch)
    Hkv = min(Hkv, 2)
    lens = [1, PAGE + 1, NP_SMALL * PAGE]
    S, pps = tpa.split_plan(1, Hkv, G, NP_SMALL, H100_SMS)
    args = _case(D + G, len(lens), Hkv, G, D, lens, NP_SMALL)
    got, want = _split_vs_oracle(args, S, pps, "bf16")
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    got32, want32 = _split_vs_oracle(args, S, pps, "fp32")
    np.testing.assert_allclose(got32, want32, rtol=3e-5, atol=3e-5)


def test_split_merge_equals_unsplit_plain_version():
    """One split is the plain version's own sum; more splits move the
    result only by rounding."""
    q, kh, vh, table, lens = (torch.from_numpy(x) for x in
                              _case(9, 3, 2, 4, 32, [70, 0, 300], 5))
    plain = tref.paged_attention_ref(q, kh, vh, table, lens)
    for S, pps in ((1, 5), (2, 3), (5, 1)):
        got = tref.paged_attention_split_ref(q, kh, vh, table, lens, S, pps)
        torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
