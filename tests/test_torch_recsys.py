"""Port vs reference: recsys serving (DLRM, DCN-v2, xDeepFM, DIEN).

JAX parameters (``repro.train.steps.init_params_for`` at each arch's
``reduced_config``) are carried into the port
(``convert.recsys_params_from_numpy``), so both packages serve with the
same weights on the same numpy batches (built as
``tests/test_arch_smoke.py`` builds them):

* the port's ``make_recsys_forward`` logits match the jitted JAX
  ``make_recsys_forward`` (B = 64), and the retrieval step matches
  ``make_recsys_retrieval_step`` (500 candidates);
* the converter round-trips the reference's trees (lists included);
* the port's configs, shapes and input specs equal the reference's
  (the LM archs' too);
* out-of-vocabulary ids give the reference's answers, including its
  quirk: an OOV id of field f reads a row of field f + 1.

Every table read of the port goes through ``ops.embedding_bag`` (its
plain version on the CPU); the JAX forwards use ``jnp.take``.
Tolerances: logits rtol 1e-4 / atol 1e-6 and retrieval scores rtol 1e-4
/ atol 1e-8 (fp32 throughout; the pooled bags and XLA's reductions sum
in other orders, and DIEN runs a 100-step GRU and AUGRU).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models import recsys as JR
from repro.train import steps as JS
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.core import convert
from repro_torch.kernels import ops as tops
from repro_torch.models import recsys as TR
from repro_torch.train import steps as TS

ARCHS = ["xdeepfm", "dcn-v2", "dlrm-mlperf", "dien"]
LOGIT_TOL = dict(rtol=1e-4, atol=1e-6)
SCORE_TOL = dict(rtol=1e-4, atol=1e-8)
B = 64


def _batch(cfg, n, rng):
    """Uniform ids per field, normal dense features, DIEN histories with
    hist_len in [1, T) (tests/test_arch_smoke.py's batches), as numpy."""
    batch = {"sparse": np.stack([rng.integers(0, v, n)
                                 for v in cfg.vocab_sizes], 1
                                ).astype(np.int32)}
    if cfg.n_dense:
        batch["dense"] = rng.normal(size=(n, cfg.n_dense)).astype(np.float32)
    if cfg.interaction == "augru":
        batch["hist"] = np.stack(
            [rng.integers(0, cfg.vocab_sizes[0], (n, cfg.seq_len)),
             rng.integers(0, cfg.vocab_sizes[1], (n, cfg.seq_len))],
            -1).astype(np.int32)
        batch["hist_len"] = rng.integers(1, cfg.seq_len, n).astype(np.int32)
    return batch


@pytest.fixture(scope="module", params=ARCHS + ["dlrm-mlperf-bf16"])
def model(request):
    """(arch, JAX cfg, port cfg, JAX params, port params); the bf16 case
    is DLRM with a bf16 table and MLPs (the chip run's cut), where the
    port must promote fp32 @ bf16 products as JAX does."""
    arch = request.param.removesuffix("-bf16")
    jcfg, tcfg = jreg.reduced_config(arch), treg.reduced_config(arch)
    if request.param.endswith("-bf16"):
        jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
        tcfg = dataclasses.replace(tcfg, param_dtype="bfloat16")
    jparams = JS.init_params_for(jreg.get(arch), jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    tparams = convert.recsys_params_from_numpy(tree, tcfg, device="cpu")
    return request.param, jcfg, tcfg, jparams, tparams


def _forwards(jcfg, tcfg, jparams, tparams, batch):
    jl = jax.jit(JS.make_recsys_forward(jcfg))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tl = TS.make_recsys_forward(tcfg, device="cpu")(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    return np.asarray(jl, np.float32), tl.float().numpy()


def test_forward_matches_reference(model):
    name, jcfg, tcfg, jparams, tparams = model
    batch = _batch(jcfg, B, np.random.default_rng(0))
    tops.reset_launch_counts()
    want, got = _forwards(jcfg, tcfg, jparams, tparams, batch)
    assert got.shape == (B,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **LOGIT_TOL, err_msg=name)
    # every table read is a bag; on the CPU none launches the kernel
    assert tops.launch_counts()["embedding_bag"] == 0


def test_retrieval_matches_reference(model):
    name, jcfg, tcfg, jparams, tparams = model
    user = _batch(jcfg, 1, np.random.default_rng(1))["sparse"]
    cand = np.arange(500, dtype=np.int32)
    want = jax.jit(JS.make_recsys_retrieval_step(jcfg))(
        jparams, jnp.asarray(user), jnp.asarray(cand))
    got = TS.make_recsys_retrieval_step(tcfg, device="cpu")(
        tparams, torch.from_numpy(user), torch.from_numpy(cand))
    assert got.shape == (500,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL,
                               err_msg=name)


def test_converter_round_trip(model):
    """Reference tree -> port -> numpy gives the same tree: the same
    nesting (lists of layer dicts), shapes and values (bf16 leaves come
    back as float32, exactly)."""
    name, jcfg, tcfg, jparams, tparams = model
    back = convert.recsys_params_to_numpy(tparams)
    ref = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    dt = getattr(torch, tcfg.param_dtype)
    assert all(t.dtype == dt for t in jax.tree.leaves(tparams))
    assert tparams["table"].shape[0] == TR.padded_rows(tcfg.total_rows)


@pytest.mark.parametrize("arch", ARCHS + [
    "tinyllama-1.1b", "gemma3-12b", "deepseek-coder-33b", "qwen2-moe-a2.7b",
    "grok-1-314b"])
def test_configs_and_shapes_equal_reference(arch):
    """Every ported arch: the config, its reduced config, its shape cells
    and the ``(shape, dtype)`` of every input of every cell."""
    j, t = jreg.get(arch), treg.get(arch)
    assert j.family == t.family
    assert dataclasses.asdict(j.config) == dataclasses.asdict(t.config)
    if j.family == "recsys":
        assert j.config.total_rows == t.config.total_rows
    assert dataclasses.asdict(jreg.reduced_config(arch)) == \
        dataclasses.asdict(treg.reduced_config(arch))
    assert [dataclasses.asdict(s) for s in j.shapes] == \
        [dataclasses.asdict(s) for s in t.shapes]
    for s in j.shapes:
        js = jreg.input_specs(arch, s.name)
        ts = treg.input_specs(arch, s.name)
        assert sorted(js) == sorted(ts)
        for k, sds in js.items():
            shape, dtype = ts[k]
            assert tuple(sds.shape) == shape
            assert np.dtype(sds.dtype).name == str(dtype).split(".")[1]
    for js, ts in ((jbase.RECSYS_SHAPES, tbase.RECSYS_SHAPES),
                   (jbase.LM_SHAPES, tbase.LM_SHAPES)):
        assert [dataclasses.asdict(s) for s in js] == \
            [dataclasses.asdict(s) for s in ts]


def test_oov_ids_read_the_next_fields_rows(model):
    """Out-of-vocabulary ids: the reference clips the FLATTENED index
    (id + field offset) to the whole padded table, so an OOV id of field
    f reads row offsets[f] + id, inside field f + 1 (its docstring says
    "the last row of their field's range"); an id past the table clips
    to its last row and a negative id of field 0 to row 0.  The port
    reproduces the code, and both forwards agree on such a batch."""
    name, jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(2)
    batch = _batch(jcfg, B, rng)
    sp = batch["sparse"]
    v0 = jcfg.vocab_sizes[0]
    sp[0, 0] = v0 + 3                             # OOV in field 0
    sp[1, -1] = 10 ** 9                           # far past the table
    sp[2, 0] = -5                                 # negative
    want, got = _forwards(jcfg, tcfg, jparams, tparams, batch)
    np.testing.assert_allclose(got, want, **LOGIT_TOL, err_msg=name)

    offs = TR.field_offsets(tcfg.vocab_sizes, "cpu")
    e = TR.embedding_lookup(tparams["table"], torch.from_numpy(sp[:3]),
                            offs)
    table = tparams["table"]
    # field 0's OOV id v0 + 3 is row v0 + 3: field 1's fourth row
    assert torch.equal(e[0, 0], table[v0 + 3])
    assert torch.equal(e[0, 0], table[int(offs[1]) + 3])
    assert torch.equal(e[1, -1], table[-1])        # the last padded row
    assert torch.equal(e[2, 0], table[0])
    je = np.asarray(JR.embedding_lookup(
        jparams["table"], jnp.asarray(sp[:3]),
        JR.field_offsets(jcfg.vocab_sizes)), np.float32)
    np.testing.assert_array_equal(e.float().numpy(), je)
