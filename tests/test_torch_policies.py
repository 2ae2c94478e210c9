"""Port vs reference: Starting-Pool policies (paper §7), term history,
churn and the hashing tokenizer.

The same histories, made from a seed with numpy, go through the JAX
policy tables and the port's; the tables must hold the same pool
indices (the reference runs with 64-bit types off, so values, not
dtypes, are compared).  A per-term table then drives both packages'
``ActiveSegment`` over the same stream: the pool states must be equal,
and the slots each allocator uses must equal the analytical model
``memory_slots_sp`` summed over the stream's term frequencies.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import history as jh
from repro.core import policies as jpol
from repro.core.index import ActiveSegment as JActive
from repro.core.pointers import PoolLayout as JLayout
from repro.data import synth
from repro.data import tokenizer as jtok
from repro_torch.core import analytical as tan
from repro_torch.core import convert
from repro_torch.core import history as th
from repro_torch.core import policies as tpol
from repro_torch.core.index import ActiveSegment as TActive
from repro_torch.core.pointers import PoolLayout as TLayout
from repro_torch.data import tokenizer as ttok

from conftest import PROD_Z

ZS = [PROD_Z, (2, 5, 9), (0, 3, 6, 8, 12)]


def _histories(seed):
    rng = np.random.default_rng(seed)
    zipf = np.minimum(rng.zipf(1.3, 3000), 1 << 20)
    edges = np.asarray([0, 1, 2, 3, 7, 8, 9, 15, 16, 17, 127, 128, 129,
                        2047, 2048, 2049, 4095, 4096, 100_000])
    ties = np.repeat(rng.integers(0, 300, 40), 25)
    return np.concatenate([zipf, edges, ties, np.zeros(50, np.int64)])


@pytest.mark.parametrize("policy", sorted(tpol.POLICIES))
@pytest.mark.parametrize("z", ZS, ids=lambda z: "z" + "-".join(map(str, z)))
@pytest.mark.parametrize("seed", [0, 1])
def test_policy_tables_match(policy, z, seed):
    hist = _histories(seed)
    want = np.asarray(jpol.start_pools_for_vocab(policy, z,
                                                 jnp.asarray(hist)))
    got = tpol.start_pools_for_vocab(policy, z, hist, device="cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        tpol.POLICIES[policy](z, hist, device="cpu").numpy(), want)


def test_policy_cases_of_the_paper():
    """The reference's hand-checked cases (sizes 2, 16, 128, 2048)."""
    got = tpol.sp_ceil(PROD_Z, [0, 1, 2, 3, 16, 17, 128, 2048, 100_000],
                       device="cpu")
    assert got.tolist() == [0, 0, 0, 1, 1, 2, 2, 3, 3]
    got = tpol.sp_floor(PROD_Z, [0, 1, 2, 3, 15, 16, 127, 128, 2048,
                                 100_000], device="cpu")
    assert got.tolist() == [0, 0, 0, 0, 0, 1, 1, 2, 3, 3]
    got = tpol.sp_lambda(PROD_Z, [0, 1, 2047, 2048, 5000], device="cpu")
    assert got.tolist() == [0, 0, 0, 3, 3]
    assert tpol.sp_default(PROD_Z, [5, 0], device="cpu").tolist() == [0, 0]


@pytest.mark.parametrize("case", ["random", "tied", "flat", "sparse",
                                  "disjoint"])
@pytest.mark.parametrize("top_k", [1, 3, 10, 10_000])
def test_churn_matches(case, top_k):
    rng = np.random.default_rng(len(case) * 31 + top_k)
    if case == "random":
        a, b = rng.integers(0, 50, 400), rng.integers(0, 50, 400)
    elif case == "tied":
        a = np.repeat(rng.integers(1, 6, 20), 10)
        b = a.copy()
        b[rng.integers(0, a.size, 30)] += 1
    elif case == "flat":
        a = np.full(60, 7, np.int64)
        b = a.copy()
    elif case == "sparse":
        a = np.zeros(500, np.int64)
        b = np.zeros(500, np.int64)
        a[rng.integers(0, 500, 8)] = rng.integers(1, 9, 8)
        b[rng.integers(0, 500, 5)] = rng.integers(1, 9, 5)
    else:
        a = np.asarray([9, 8, 7, 0, 0, 0])
        b = np.asarray([0, 0, 0, 9, 8, 7])
    assert th.churn(a, b, top_k=top_k) == jh.churn(a, b, top_k=top_k)
    assert th.churn(a, a, top_k=top_k) == 0.0


def test_churn_ties_break_stably():
    flat = np.full(50, 7, np.int64)
    assert th.churn(flat, flat.copy(), top_k=10) == 0.0
    a = np.asarray([3, 3, 3, 3])
    assert th.churn(a, np.asarray([4, 4, 3, 3]), top_k=2) == 0.0
    assert th.churn(a, np.asarray([3, 3, 4, 4]), top_k=2) == \
        pytest.approx(1.0)
    assert th.churn(np.asarray([100, 90, 80, 1, 1]),
                    np.asarray([1, 90, 80, 100, 1]), top_k=3) == \
        pytest.approx(1 / 3)


def test_history_from_freqs_matches():
    f = np.random.default_rng(2).integers(0, 1 << 20, 64)
    for x in (f, f.tolist(), f.astype(np.int32)):
        got = th.history_from_freqs(x)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, jh.history_from_freqs(f))


def _stream(seed, vocab=3000, n_docs=1200):
    spec = synth.CorpusSpec(vocab=vocab, n_docs=n_docs, seed=seed)
    first, second = synth.corpus_halves(spec)
    return spec, synth.term_freqs(first, spec.vocab), second


def _analytic_slots(z, freqs, table):
    live = freqs > 0
    return int(tan.memory_slots_sp(z, freqs[live], table[live]).sum())


@pytest.mark.parametrize("policy", sorted(tpol.POLICIES))
def test_segment_under_each_policy_matches(policy):
    """The per-term start table drives both packages' ActiveSegment over
    the same second half of a stream, in batches: equal pool states,
    and both allocators use exactly the analytical model's slots."""
    spec, hist, second = _stream(seed=3)
    spp = (8192, 4096, 2048, 512)
    jseg = JActive(JLayout(z=PROD_Z, slices_per_pool=spp), spec.vocab)
    tseg = TActive(TLayout(z=PROD_Z, slices_per_pool=spp), spec.vocab,
                   device="cpu")
    jtable = jpol.start_pools_for_vocab(policy, PROD_Z, jnp.asarray(hist))
    ttable = tpol.start_pools_for_vocab(policy, PROD_Z, hist, device="cpu")
    for s in range(0, second.shape[0], 150):
        jseg.ingest(jnp.asarray(second[s: s + 150]),
                    term_start_pools=jtable)
        tseg.ingest(second[s: s + 150], term_start_pools=ttable)
    jseg.check_health()
    tseg.check_health()
    got = convert.pool_state_to_numpy(tseg.state)
    for f in got:
        np.testing.assert_array_equal(
            got[f], np.asarray(getattr(jseg.state, f)), err_msg=f)
    freqs = synth.term_freqs(second, spec.vocab)
    want = _analytic_slots(PROD_Z, freqs, ttable.numpy())
    assert tseg.memory_slots_used() == want == jseg.memory_slots_used()


def test_sp_policies_waste_memory_without_history_value():
    """The paper's §9.2 finding, qualitatively, on the port: with churn,
    SP(ceil) uses more memory than the default, SP(Lambda) about the
    same."""
    spec, hist, second = _stream(seed=3)
    layout = TLayout(z=PROD_Z, slices_per_pool=(8192, 4096, 2048, 512))

    def run(policy):
        seg = TActive(layout, spec.vocab, device="cpu")
        table = tpol.start_pools_for_vocab(policy, PROD_Z, hist,
                                           device="cpu")
        seg.ingest(second, term_start_pools=table)
        seg.check_health()
        return seg.memory_slots_used()

    default, ceil, lam = (run(p) for p in ("sp_default", "sp_ceil",
                                           "sp_lambda"))
    assert ceil > default
    assert lam >= default
    assert (lam - default) <= (ceil - default)


TEXTS = ["Breaking: #earthquake hits @cityhall, more at 11",
         "RT @user: the quick brown fox", "", "   ",
         "ünïcödé words and numbers 12345 #Tag_1",
         "a " * 100, "MiXeD CaSe tweet; punctuation!!! ok?"]


@pytest.mark.parametrize("vocab", [1 << 10, 1 << 20, 997])
def test_tokenizer_ids_match(vocab):
    for t in TEXTS:
        assert ttok.tokenize(t) == jtok.tokenize(t)
        assert [ttok.term_id(w, vocab) for w in ttok.tokenize(t)] == \
            [jtok.term_id(w, vocab) for w in jtok.tokenize(t)]
        q, n = ttok.encode_query(t, vocab)
        qj, nj = jtok.encode_query(t, vocab)
        assert n == nj and q.dtype == qj.dtype
        np.testing.assert_array_equal(q, qj)
    got = ttok.encode_docs(TEXTS, vocab)
    want = jtok.encode_docs(TEXTS, vocab)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ttok.encode_docs(TEXTS, vocab, max_len=3),
                                  jtok.encode_docs(TEXTS, vocab, max_len=3))
