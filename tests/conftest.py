"""Shared fixtures. NOTE: no XLA_FLAGS set here — the in-process suite
runs on whatever the environment provides: 1 real CPU device locally, 4
forced host devices in CI (.github/workflows/ci.yml). Tests must not
assume a specific device count; subprocess tests (spmd equivalence,
launch/dryrun.py) force their own counts in their own processes."""
import sys

try:                                   # prefer the real hypothesis…
    import hypothesis  # noqa: F401
except ImportError:                    # …fall back to the seeded shim
    import _hypothesis_shim
    sys.modules["hypothesis"] = _hypothesis_shim
    sys.modules["hypothesis.strategies"] = _hypothesis_shim.strategies

import numpy as np
import pytest

import jax.numpy as jnp

from repro.core import analytical
from repro.core.index import ActiveSegment
from repro.core.pointers import PoolLayout
from repro.data import synth

PROD_Z = (1, 4, 7, 11)


@pytest.fixture(scope="session")
def small_layout():
    return PoolLayout(z=PROD_Z, slices_per_pool=(4096, 2048, 1024, 512))


@pytest.fixture(scope="session")
def small_corpus():
    spec = synth.CorpusSpec(vocab=2000, n_docs=500, seed=0)
    return spec, synth.zipf_corpus(spec)


@pytest.fixture(scope="session")
def indexed_segment(small_layout, small_corpus):
    spec, docs = small_corpus
    seg = ActiveSegment(small_layout, spec.vocab)
    seg.ingest(jnp.asarray(docs))
    seg.check_health()
    return seg, docs, synth.term_freqs(docs, spec.vocab)


def max_slices_for(z, freqs):
    fmax = max(int(np.max(freqs)), 1)
    return int(analytical.slices_needed(z, fmax)) + 1


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one); run on "
        "the card with `python -m pytest -m cuda tests/test_torch_*.py`")
