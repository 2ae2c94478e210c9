"""Port vs reference: SchNet (``models/schnet.py``).

The reference's ``init_schnet`` tree is carried into the port
(``convert.gnn_params_from_numpy``), the same numpy graphs (made from a
seed) go to both, and the port's ``schnet_forward`` and ``schnet_loss``
are held against the jitted reference at the reduced config and at the
published widths (3 interactions, d_hidden 64, n_rbf 300, cutoff 10),
on a featureful graph and on a batch of molecules (the inputs of
``tests/test_arch_smoke.py``'s SchNet tests):

* the radial-basis centres bit-equal to ``jnp.linspace``'s at both
  widths, the expansion within 1e-7 (one fp32 ulp of ``exp``);
* ``ssp`` within 3e-7 of ``jax.nn.softplus - log 2`` over [-30, 30]
  (``torch.nn.functional.softplus`` is 1.9e-6 off past its threshold);
* per-node outputs and per-graph readouts within 1e-5 (fp32; XLA and
  torch sum in other orders), the loss within 1e-5 relative;
* ids out of range raise on the CPU, where the reference fills NaN,
  drops or clamps (ROADMAP.md Queue 3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import schnet as JG
from repro.train import steps as JS
from repro_torch.configs import registry as treg
from repro_torch.core import convert
from repro_torch.models import schnet as TG
from repro_torch.train import steps as TS
from repro_torch.train import tree

TOL = dict(rtol=1e-5, atol=1e-5)
SSP_TOL = 3e-7
CONFIGS = ("reduced", "published")
GRAPHS = ("featureful", "molecules")


def _configs(which):
    if which == "reduced":
        return jreg.reduced_config("schnet"), treg.reduced_config("schnet")
    return jreg.get("schnet").config, treg.get("schnet").config


def featureful(seed=0, N=50, E=200, F=16):
    """``test_arch_smoke.test_schnet_smoke``'s graph."""
    rng = np.random.default_rng(seed)
    return dict(
        node_feat=rng.normal(size=(N, F)).astype(np.float32),
        src=rng.integers(0, N, E).astype(np.int32),
        dst=rng.integers(0, N, E).astype(np.int32),
        edge_dist=rng.uniform(0, 10, E).astype(np.float32),
        graph_id=np.zeros((N,), np.int32),
        targets=np.asarray([1.0], np.float32)), 1


def molecules(seed=1, n_g=8, n_per=6, e_per=12):
    """``test_arch_smoke.test_schnet_molecule_batched``'s batch, with
    per-graph targets."""
    rng = np.random.default_rng(seed)
    N, E = n_g * n_per, n_g * e_per
    base = np.repeat(np.arange(n_g) * n_per, e_per)
    return dict(
        atom_type=rng.integers(0, 10, N).astype(np.int32),
        src=(rng.integers(0, n_per, E) + base).astype(np.int32),
        dst=(rng.integers(0, n_per, E) + base).astype(np.int32),
        edge_dist=rng.uniform(0, 10, E).astype(np.float32),
        graph_id=np.repeat(np.arange(n_g), n_per).astype(np.int32),
        targets=rng.normal(size=n_g).astype(np.float32)), n_g


def graph(kind):
    return featureful() if kind == "featureful" else molecules()


@functools.lru_cache(maxsize=None)
def models(which):
    """(jcfg, tcfg, reference params, port params on the CPU)."""
    jcfg, tcfg = _configs(which)
    jp = JG.init_schnet(jcfg, jax.random.key(0), d_feat=16)
    tp = convert.gnn_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                       "cpu")
    return jcfg, tcfg, jp, tp


@functools.lru_cache(maxsize=None)
def jitted(which, n_graphs):
    """The reference's forward and loss in one jitted function a config
    (one compile each)."""
    jcfg = models(which)[0]

    def fwd_loss(params, batch):
        g = JG.GraphBatch(
            node_feat=batch.get("node_feat"),
            atom_type=batch.get("atom_type"), src=batch["src"],
            dst=batch["dst"], edge_dist=batch["edge_dist"],
            graph_id=batch["graph_id"], n_graphs=n_graphs)
        return (JS.make_gnn_forward(jcfg, n_graphs=n_graphs)(params, batch),
                JG.schnet_loss(params, g, batch["targets"], jcfg))
    return jax.jit(fwd_loss)


def _batches(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.as_tensor(v) for k, v in b.items()})


@pytest.mark.parametrize("which", CONFIGS)
def test_rbf_centers_bit_equal_to_reference(which):
    jcfg, tcfg = _configs(which)
    want = np.asarray(jnp.linspace(0.0, jcfg.cutoff, jcfg.n_rbf))
    got = TG.rbf_centers(tcfg.n_rbf, tcfg.cutoff, "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    dist = np.random.default_rng(3).uniform(0, 12, 500).astype(np.float32)
    ref = jax.jit(lambda d: JG.rbf_expand(d, jcfg.n_rbf, jcfg.cutoff))(
        jnp.asarray(dist))
    np.testing.assert_allclose(
        TG.rbf_expand(torch.as_tensor(dist), tcfg.n_rbf, tcfg.cutoff),
        np.asarray(ref), rtol=0, atol=1e-7)


def test_ssp_matches_reference():
    x = np.linspace(-30, 30, 60001, dtype=np.float32)
    want = np.asarray(jax.jit(JG.ssp)(jnp.asarray(x)))
    xt = torch.as_tensor(x).requires_grad_(True)
    got = TG.ssp(xt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=SSP_TOL)
    got.sum().backward()
    gwant = np.asarray(jax.jit(jax.grad(lambda v: JG.ssp(v).sum()))(
        jnp.asarray(x)))
    np.testing.assert_allclose(xt.grad.numpy(), gwant, rtol=0, atol=1e-6)


def test_init_schnet_matches_reference_tree():
    """Same leaves (paths, shapes, dtypes), the biases zero, the dense
    scales fan_in ** -0.5 and the atom table's 1.0 (within sampling
    error); one seed gives the same bits twice."""
    cfg = treg.get("schnet").config
    ref = jax.eval_shape(lambda k: JG.init_schnet(
        jreg.get("schnet").config, k, d_feat=602), jax.random.key(0))
    gen = torch.Generator().manual_seed(0)
    tp = TG.init_schnet(cfg, gen, d_feat=602, device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(ref)[0]
    tl = list(tree.items_with_path(tp))
    assert [tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
            for p, _ in jl] == [p for p, _ in tl]
    for (_, j), (path, t) in zip(jl, tl):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32, path
        if path[-1].endswith("_b"):
            assert not t.any()
        else:
            scale = 1.0 if path == ("embed_atom",) else t.shape[-2] ** -0.5
            assert abs(float(t.std()) / scale - 1) < 0.25, path
    again = TG.init_schnet(cfg, torch.Generator().manual_seed(0), 602,
                           device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(tp),
                                                   tree.leaves(again)))


def test_gnn_params_cross_both_ways():
    jcfg, tcfg, jp, tp = models("published")
    back = convert.gnn_params_to_numpy(tp)
    jl = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jp))[0]
    tl = list(tree.items_with_path(back))
    assert len(jl) == len(tl) == 4 + 8 * tcfg.n_interactions
    for (_, j), (_, t) in zip(jl, tl):
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)
    assert isinstance(tp["interactions"], list)


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("which", CONFIGS)
def test_forward_and_loss_match_reference(which, kind):
    jcfg, tcfg, jp, tp = models(which)
    b, n_graphs = graph(kind)
    jb, tb = _batches(b)
    (jout, jen), jloss = jitted(which, n_graphs)(jp, jb)
    tout, ten = TS.make_gnn_forward(tcfg, n_graphs, device="cpu")(tp, tb)
    N = b["graph_id"].shape[0]
    assert tout.shape == (N, 1) and ten.shape == (n_graphs, 1)
    assert tout.dtype == ten.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(ten.numpy(), np.asarray(jen), **TOL)
    g = TS._graph_batch(tb, n_graphs)
    # the module-level forward (centres made per call) is the same
    o2, e2 = TG.schnet_forward(tp, g, tcfg)
    assert torch.equal(o2, tout) and torch.equal(e2, ten)
    tl = TG.schnet_loss(tp, g, tb["targets"], tcfg)
    assert tl.dtype == torch.float32 and tl.shape == ()
    np.testing.assert_allclose(float(tl), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("field", ["src", "dst", "graph_id", "atom_type"])
def test_out_of_range_ids_raise_on_the_cpu(field):
    """The port's contract: ids in range.  The reference reads NaN for a
    ``src`` past N, drops a ``dst`` or ``graph_id`` past its segments and
    clamps an atom type; the port raises on the CPU rather than imitate
    any of it on its main path."""
    jcfg, tcfg, jp, tp = models("reduced")
    b, n_graphs = molecules()
    bound = {"src": 48, "dst": 48, "graph_id": n_graphs, "atom_type": 100}
    for bad in (bound[field], -1):
        b2 = dict(b)
        b2[field] = b[field].copy()
        b2[field][3] = bad
        tb = {k: torch.as_tensor(v) for k, v in b2.items()}
        with pytest.raises((IndexError, RuntimeError)):
            TS.make_gnn_forward(tcfg, n_graphs, device="cpu")(tp, tb)
    if field == "src":      # the reference's NaN fill, for the record
        b2 = dict(b)
        b2["src"] = b["src"].copy()
        b2["src"][3] = bound["src"]
        jb = {k: jnp.asarray(v) for k, v in b2.items()}
        (_, jen), _ = jitted("reduced", n_graphs)(jp, jb)
        assert np.isnan(np.asarray(jen)).any()
