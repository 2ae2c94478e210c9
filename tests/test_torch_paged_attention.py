"""Port vs reference: paged decode attention.

The port's plain ``paged_attention_ref`` (what ``ops.paged_attention``
runs on a CPU tensor) against the JAX oracle ``repro.kernels.ref.
paged_attention_ref`` at the JAX kernel tests' shapes, with lengths at
and next to page edges, a length-0 row and a row longer than its table;
and against the JAX Pallas kernel in interpret mode at one small shape.
Tolerances as in the JAX package's own kernel tests: 3e-5 in fp32, 2e-2
for bf16 inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref

PAGE = 64


def _case(seed, B, Hkv, G, D, lens, n_free_pages=64, NP=None):
    """numpy inputs: q, heaps, a page table of distinct random pages
    (``NP`` columns; a row whose length needs more pages than that gets
    the table's NP) and the lengths."""
    rng = np.random.default_rng(seed)
    need = [-(-n // PAGE) for n in lens]
    NP = NP or max(max(need), 1)
    perm = rng.permutation(n_free_pages)
    table = np.full((B, NP), -1, np.int32)
    pi = 0
    for b, npg in enumerate(need):
        npg = min(npg, NP)
        table[b, :npg] = perm[pi:pi + npg]
        pi += npg
    slots = n_free_pages * PAGE
    q = rng.normal(size=(B, Hkv, G, D)).astype(np.float32)
    kh = rng.normal(size=(Hkv, slots, D)).astype(np.float32)
    vh = rng.normal(size=(Hkv, slots, D)).astype(np.float32)
    return q, kh, vh, table, np.asarray(lens, np.int32)


def _both(args, dtype=np.float32):
    """(port output, JAX oracle output) on the same inputs."""
    q, kh, vh, table, lens = args
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, kh, vh))
    # the JAX side sees exactly the bf16-rounded values
    jq, jk, jv = (jnp.asarray(t.float().numpy(),
                              jnp.bfloat16 if dtype == "bf16"
                              else jnp.float32) for t in (tq, tk, tv))
    got = ops.paged_attention(tq, tk, tv, torch.from_numpy(table),
                              torch.from_numpy(lens))
    want = jref.paged_attention_ref(jq, jk, jv, jnp.asarray(table),
                                    jnp.asarray(lens))
    return got.numpy(), np.asarray(want)


EDGE = [0, 1, PAGE - 1, PAGE, PAGE + 1, 2 * PAGE, 5 * PAGE - 3]


@pytest.mark.parametrize("B,Hkv,G,D", [
    (1, 1, 1, 16), (2, 2, 4, 32), (3, 4, 2, 64), (2, 1, 8, 128),
])
def test_plain_matches_jax_oracle(B, Hkv, G, D):
    rng = np.random.default_rng(D)
    lens = [int(x) for x in rng.choice(EDGE[1:], B)]
    lens[0] = 0 if B > 1 else lens[0]          # a wholly masked row
    got, want = _both(_case(B * 7 + D, B, Hkv, G, D, lens))
    assert got.dtype == np.float32 and got.shape == (B, Hkv, G, D)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
    if B > 1:
        assert not got[0].any()


@pytest.mark.parametrize("lens", [[n] for n in EDGE] + [EDGE])
def test_plain_matches_jax_oracle_at_page_edges(lens):
    got, want = _both(_case(len(lens), len(lens), 2, 2, 16, lens))
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)


def test_row_longer_than_its_table():
    """A reused serving slot can be longer than its page table: both
    versions attend over the table's NP pages only."""
    args = _case(3, 2, 2, 4, 32, [3 * PAGE + 5, 2 * PAGE + 9], NP=2)
    got, want = _both(args)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
    q, kh, vh, table, _ = args
    trimmed = np.asarray([2 * PAGE, 2 * PAGE], np.int32)
    same, _ = _both((q, kh, vh, table, trimmed))
    np.testing.assert_allclose(got, same, rtol=1e-6, atol=1e-6)


def test_plain_matches_jax_oracle_bf16():
    got, want = _both(_case(5, 2, 2, 2, 32, [70, 200]), "bf16")
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_plain_matches_pallas_interpret():
    """The JAX Pallas kernel itself (interpret mode), one small shape
    whose rows fit their table."""
    q, kh, vh, table, lens = _case(11, 2, 2, 2, 16,
                                   [PAGE + 1, 2 * PAGE])
    got = tref.paged_attention_ref(*(torch.from_numpy(x) for x in
                                     (q, kh, vh, table, lens)))
    want = jops.paged_attention(jnp.asarray(q), jnp.asarray(kh),
                                jnp.asarray(vh), jnp.asarray(table),
                                jnp.asarray(lens), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)


def test_cuda_wrapper_rejects_cpu_tensors():
    """The kernel wrapper never runs on the CPU: ``ops`` routes a CPU
    tensor to the plain version, the wrapper itself raises."""
    q, kh, vh, table, lens = (torch.from_numpy(x) for x in
                              _case(1, 1, 1, 1, 16, [3]))
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention(q, kh, vh, table, lens)
