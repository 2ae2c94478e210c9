"""Port vs reference: the registry and the per-arch config modules.

* Each of the ten ``configs/<arch>.py`` modules' ``CONFIG`` equals the
  reference's, field by field (the per-arch modules are four-line
  re-exports of ``lm_archs`` and ``other_archs``).
* The registry has the reference's archs, families and shapes;
  ``input_specs`` gives the reference's shapes and dtypes for every
  (arch, shape) cell, as ``(shape, torch.dtype)`` pairs where the
  reference gives ``jax.ShapeDtypeStruct``; ``_gnn_sample_sizes`` and
  ``reduced_config`` equal the reference's.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as jreg
from repro_torch.configs import registry as treg

MODULES = ("tinyllama_1b", "gemma3_12b", "deepseek_coder_33b",
           "qwen2_moe_a2_7b", "grok_1_314b", "schnet", "dcn_v2", "dien",
           "dlrm_mlperf", "xdeepfm")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
CELLS = [(a, s.name) for a, e in jreg.ARCHS.items() for s in e.shapes]


@pytest.mark.parametrize("module", MODULES)
def test_config_module_matches_reference(module):
    j = importlib.import_module(f"repro.configs.{module}")
    t = importlib.import_module(f"repro_torch.configs.{module}")
    assert t.__all__ == ["CONFIG"]
    assert type(t.CONFIG).__name__ == type(j.CONFIG).__name__
    assert dataclasses.asdict(t.CONFIG) == dataclasses.asdict(j.CONFIG)
    # each module re-exports the registry's own config
    assert t.CONFIG is treg.get(t.CONFIG.name).config


def test_registry_matches_reference():
    assert list(treg.ARCHS) == list(jreg.ARCHS)
    for arch, j in jreg.ARCHS.items():
        t = treg.get(arch)
        assert t.family == j.family
        assert [dataclasses.asdict(s) for s in t.shapes] == \
            [dataclasses.asdict(s) for s in j.shapes]
        assert dataclasses.asdict(t.config) == dataclasses.asdict(j.config)
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get("gcn")


_DTYPES = {jnp.int32: torch.int32, jnp.float32: torch.float32}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    want = jreg.input_specs(arch, shape)
    got = treg.input_specs(arch, shape)
    assert list(got) == list(want)
    for k, sds in want.items():
        assert got[k] == (sds.shape, _DTYPES[sds.dtype.type]), k


@pytest.mark.parametrize("shape", GNN_SHAPES)
def test_gnn_sample_sizes_match_reference(shape):
    n, e = treg._gnn_sample_sizes(treg.get_shape("schnet", shape))
    assert (n, e) == jreg._gnn_sample_sizes(jreg.get_shape("schnet", shape))
    if shape == "minibatch_lg":
        assert (n, e) == (180_224, 179_200)


def test_reduced_schnet_matches_reference():
    t, j = treg.reduced_config("schnet"), jreg.reduced_config("schnet")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.n_rbf == 16 and t.d_hidden == 64
