"""Port vs reference: the GNN train step and the GNN parts of
``train/steps.py`` (``make_gnn_train_step``, ``make_gnn_forward``,
``init_params_for`` on SchNet).

The reference's parameters and AdamW state are carried into the port,
the same numpy batches go to both, and two steps of the port's
``make_gnn_train_step`` are held against the jitted reference step at
the reduced config on a featureful graph and at the published widths
on a batch of molecules and on a subgraph the sampler drew from a
random graph (the whole slice: ``random_graph`` -> ``sample_subgraph`` ->
batch -> step): loss within 1e-5 relative, parameters within 1e-5
(relative and absolute), and both moments within 1e-4 of each leaf's
largest value.  XLA and torch sum the E messages into N nodes and the N
node outputs into the readout in other orders, and a gradient entry can
be far below the terms that make it (up to 3.1e-5 of the leaf's largest
seen).  AdamW runs with eps 1e-6, not its default 1e-8: these gradients
reach down to 1e-9, and there Adam divides summation noise by itself
(an element moves by up to 2 lr either way).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import graph_sampler as JD
from repro.train import steps as JS
from repro.train.optimizer import AdamW as JAdamW
from repro_torch.configs import registry as treg
from repro_torch.core import convert
from repro_torch.data import graph_sampler as TD
from repro_torch.models import schnet as TG
from repro_torch.train import steps as TS
from repro_torch.train import tree
from repro_torch.train.optimizer import AdamW as TAdamW

from test_torch_schnet import featureful, molecules

OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10, eps=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)
MOMENT_ATOL = 1e-4          # times the leaf's largest |moment|


def sampled(seed=2, pad=(600, 600)):
    """A sampler minibatch: 16 seeds, fanout (4, 3), padded, d_feat 24;
    the reference's and the port's samplers draw the same subgraph."""
    gj = JD.random_graph(500, avg_degree=6, seed=seed)
    gt = TD.random_graph(500, avg_degree=6, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    seeds = rng.choice(500, 16, replace=False)
    sub = TD.sample_subgraph(gt, seeds, (4, 3), np.random.default_rng(seed),
                             *pad)
    want = JD.sample_subgraph(gj, seeds, (4, 3), np.random.default_rng(seed),
                              *pad)
    assert all(np.array_equal(sub[k], want[k]) for k in ("src", "dst",
                                                        "node_ids"))
    n, e = len(sub["node_ids"]), len(sub["src"])
    return dict(
        node_feat=rng.normal(size=(n, 24)).astype(np.float32),
        src=sub["src"], dst=sub["dst"],
        edge_dist=rng.uniform(0, 10, e).astype(np.float32),
        graph_id=np.zeros(n, np.int32),
        targets=np.asarray([0.5], np.float32)), 1


GRAPHS = {"featureful": featureful, "molecules": molecules,
          "sampled": sampled}


def _configs(which):
    if which == "reduced":
        return jreg.reduced_config("schnet"), treg.reduced_config("schnet")
    return jreg.get("schnet").config, treg.get("schnet").config


@functools.lru_cache(maxsize=None)
def jitted_step(which, n_graphs):
    return jax.jit(JS.make_gnn_train_step(_configs(which)[0],
                                          JAdamW(**OPT), n_graphs=n_graphs))


def _compare(jtree, ttree, what, leaf_scale=False):
    jl = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jtree))[0]
    tl = list(tree.items_with_path(convert.gnn_params_to_numpy(ttree)))
    assert len(jl) == len(tl), what
    for (_, j), (tp, t) in zip(jl, tl):
        atol = (MOMENT_ATOL * float(np.abs(j).max(initial=0.0))
                if leaf_scale else TOL["atol"])
        np.testing.assert_allclose(t, j, rtol=TOL["rtol"], atol=atol,
                                   err_msg=f"{what} {tp}")


@pytest.mark.parametrize("which,kind", [
    ("reduced", "featureful"), ("published", "molecules"),
    ("published", "sampled")])
def test_gnn_train_step_matches_reference(which, kind):
    jcfg, tcfg = _configs(which)
    b, n_graphs = GRAPHS[kind]()
    d_feat = b["node_feat"].shape[1] if "node_feat" in b else 16
    jp = JS.init_params_for(jreg.get("schnet"), jcfg, jax.random.key(1),
                            jreg.get_shape("schnet", "full_graph_sm"))
    jp = jax.tree.map(np.asarray, jp)
    jp["embed_feat"] = jp["embed_feat"][:d_feat]
    tp = convert.gnn_params_from_numpy(jp, tcfg, "cpu")
    jopt, topt = JAdamW(**OPT), TAdamW(**OPT)
    js = jopt.init(jax.tree.map(jnp.asarray, jp))
    ts = convert.opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    jstep = jitted_step(which, n_graphs)
    tstep = TS.make_gnn_train_step(tcfg, topt, n_graphs=n_graphs)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    for _ in range(2):
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        assert set(tm) == {"loss"} and tm["loss"].dtype == torch.float32
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=TOL["rtol"])
    assert int(ts.step) == int(js.step) == 2
    _compare(jp, tp, f"{which} {kind} params")
    _compare(js.mu, ts.mu, f"{which} {kind} mu", leaf_scale=True)
    _compare(js.nu, ts.nu, f"{which} {kind} nu", leaf_scale=True)


def test_gnn_step_is_deterministic_and_leaves_its_inputs():
    """The step is pure: the same state gives the same bits, and the
    parameters and state it was given are unchanged."""
    tcfg = treg.reduced_config("schnet")
    b, n_graphs = molecules()
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    tp = TS.init_params_for(treg.get("schnet"), tcfg, seed=3, device="cpu")
    opt = TAdamW(**OPT)
    ts = opt.init(tp)
    before = [t.clone() for t in tree.leaves((tp, ts))]
    step = TS.make_gnn_train_step(tcfg, opt, n_graphs=n_graphs)
    a = step(tp, ts, tb)
    c = step(tp, ts, tb)
    assert all(torch.equal(x, y) for x, y in zip(tree.leaves(a),
                                                 tree.leaves(c)))
    assert all(torch.equal(x, y) for x, y in zip(before,
                                                 tree.leaves((tp, ts))))


@pytest.mark.parametrize("shape", ["full_graph_sm", "minibatch_lg",
                                   "ogb_products", "molecule", None])
def test_init_params_for_gnn(shape):
    """The input width is the shape's ``d_feat`` (else the config's
    default), the tree the reference's, at the published widths."""
    cfg = treg.get("schnet").config
    spec = treg.get_shape("schnet", shape) if shape else None
    jspec = jreg.get_shape("schnet", shape) if shape else None
    want = jax.eval_shape(lambda k: JS.init_params_for(
        jreg.get("schnet"), jreg.get("schnet").config, k, jspec),
        jax.random.key(0))
    got = TS.init_params_for(treg.get("schnet"), cfg, seed=0,
                             shape_spec=spec, device="cpu")
    assert [tuple(t.shape) for t in tree.leaves(got)] == \
        [j.shape for j in jax.tree.leaves(want)]
    assert got["embed_feat"].shape[0] == (
        spec.extra("d_feat", cfg.d_feat_default) if spec else 128)
    again = TS.init_params_for(treg.get("schnet"), cfg, seed=0,
                               shape_spec=spec, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(got),
                                                 tree.leaves(again)))


def test_gnn_forward_runs_in_bf16_like_the_reference():
    """A bf16 compute dtype promotes as JAX does (the fp32 radial basis
    keeps the filter products in fp32): outputs within bf16's rounding
    of the reference's."""
    jcfg = dataclasses.replace(jreg.reduced_config("schnet"),
                               compute_dtype="bfloat16")
    tcfg = dataclasses.replace(treg.reduced_config("schnet"),
                               compute_dtype="bfloat16")
    b, n_graphs = featureful()
    jp = JS.init_params_for(jreg.get("schnet"), jcfg, jax.random.key(0))
    jp = jax.tree.map(np.asarray, jp)
    jp["embed_feat"] = jp["embed_feat"][:16]
    tp = convert.gnn_params_from_numpy(jp, tcfg, "cpu")
    jo, je = jax.jit(JS.make_gnn_forward(jcfg, n_graphs))(
        jp, {k: jnp.asarray(v) for k, v in b.items() if k != "targets"})
    to, te = TS.make_gnn_forward(tcfg, n_graphs, "cpu")(
        tp, {k: torch.as_tensor(v) for k, v in b.items()})
    assert to.dtype == torch.float32 and np.asarray(jo).dtype == np.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=2e-2,
                               atol=2e-2 * len(b["graph_id"]))
    assert TG.rbf_centers(16, 10.0, "cpu").dtype == torch.float32
