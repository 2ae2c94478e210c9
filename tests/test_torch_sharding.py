"""Port vs reference: the logical spec trees and the sharding rules
(``dist/sharding.py``, ``launch/dryrun.rules_for``).

* For every arch, the port's spec trees equal the reference's:
  ``param_specs_for`` (``lm_param_specs``, ``schnet_param_specs``, the
  four recsys tables), ``decode_cache_specs`` with and without
  ``kv_quant``, and ``moe_layer_specs`` on both sides of the EP rule.
* ``Rules.spec`` equals the reference's ``Rules.spec`` (its
  ``PartitionSpec`` as a tuple) for every parameter, cache and activation
  spec, under ``default_rules`` and under ``rules_for`` (with ``fsdp``,
  ``seq_sharded``, ``fsdp_pure`` and ``rows=dp_model``), on (16, 16) and
  (2, 16, 16) stand-in meshes.  The reference's ``rules_for`` lives in
  ``repro.launch.dryrun``, which forces 512 host devices when imported,
  so it runs in a subprocess that prints its specs as JSON.
* ``placements`` per mesh dim, the rank check before the no-rules
  return, ``constrain`` as a no-op, ``use_rules`` nesting and
  ``tree_shardings`` keeping a NamedTuple a container.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.configs import registry as jreg
from repro.dist import sharding as JSH
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.train import steps as JS
from repro_torch.configs import registry as treg
from repro_torch.dist import sharding as TSH
from repro_torch.launch import dryrun as TD
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.train import steps as TS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list(treg.ARCHS)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
VARIANTS = [{}, {"fsdp": True}, {"seq_sharded": True},
            {"scheme": "fsdp_pure"}, {"rows": "dp_model"},
            {"fsdp": False, "rows": "model"}]
ACTIVATIONS = [("batch", "seq", None), ("batch", None, "model", None),
               ("batch", None, "model"), ("batch", "model"), ("edges",),
               ("edges", None), ("batch", None, None), ("batch", None),
               (None, "batch", None), (None, "batch", "model"),
               ("batch",), ("expert", "fsdp"), ("docs", "shard"),
               ("rows", None), ("kv_seq", "seq", "model")]


class FakeMesh:
    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


def canon(tree):
    """A spec tree as JSON-like data: a NamedTuple by its fields, a spec
    tuple as a list, ``None`` kept."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: canon(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: canon(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [canon(v) for v in tree]
    if isinstance(tree, tuple):
        return [canon(v) for v in tree]
    return tree


def spec_leaves(tree, is_leaf=TSH.is_spec_leaf):
    if is_leaf(tree):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [x for v in vals for x in spec_leaves(v)]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_trees_match_reference(arch):
    je, te = jreg.get(arch), treg.get(arch)
    for size in (16, 4):
        assert canon(TS.param_specs_for(te, te.config, size)) == \
            canon(JS.param_specs_for(je, je.config, size))
    if te.family == "lm":
        for quant in (False, True):
            jc = dataclasses.replace(je.config, kv_quant=quant)
            tc = dataclasses.replace(te.config, kv_quant=quant)
            assert canon(TT.decode_cache_specs(tc)) == \
                canon(JT.decode_cache_specs(jc))


@pytest.mark.parametrize("n_experts,pad,size", [
    (60, 0, None), (60, 64, None), (64, 0, None), (8, 0, 4), (8, 0, 16),
    (6, 0, 4)])
def test_moe_layer_specs_both_sides_of_the_ep_rule(n_experts, pad, size):
    kw = dict(name="m", n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
              d_ff=128, vocab=256, moe=True, n_experts=n_experts,
              moe_top_k=2, n_shared_experts=1, moe_d_ff=32, moe_ep_pad=pad)
    from repro.configs.base import LMConfig as JC
    from repro_torch.configs.base import LMConfig as TC
    got = TM.moe_layer_specs(TC(**kw), size)
    assert canon(got) == canon(JM.moe_layer_specs(JC(**kw), size))
    ep = (pad or n_experts) % (size or 16) == 0
    assert (got["experts"]["w_gate"][0] == "model") == ep


REF_RULES = textwrap.dedent("""
    import json, sys
    from repro.launch import dryrun as D
    from repro.dist import sharding as SH
    from repro.configs import registry
    from repro.models import transformer as T
    from repro.train import steps as S

    class FakeMesh:
        def __init__(self, shape, axes):
            self.shape = dict(zip(axes, shape))
            self.axis_names = tuple(axes)

    cases = json.loads(sys.stdin.read())
    out = []
    for c in cases:
        mesh = FakeMesh(*c["mesh"])
        if c["kind"] == "default":
            rules = SH.default_rules(mesh, **c["kw"])
        else:
            entry = registry.get(c["arch"])
            spec = registry.get_shape(c["arch"], c["shape"])
            ov = registry.overrides(c["arch"], c["shape"])
            ov.update(c["kw"])
            rules = D.rules_for(mesh, entry, spec, ov)
        specs = [None if s is None else tuple(s) for s in c["specs"]]
        out.append([[list(x) if isinstance(x, tuple) else x
                     for x in rules.spec(s)] for s in specs])
    print(json.dumps(out))
""")


def _port_rules(case):
    mesh = FakeMesh(*case["mesh"])
    if case["kind"] == "default":
        return TSH.default_rules(mesh, **case["kw"])
    ov = treg.overrides(case["arch"], case["shape"])
    ov.update(case["kw"])
    return TD.rules_for(mesh, treg.get(case["arch"]),
                        treg.get_shape(case["arch"], case["shape"]), ov)


def _leaf_specs(arch):
    entry = treg.get(arch)
    specs = spec_leaves(TS.param_specs_for(entry, entry.config, 16))
    if entry.family == "lm":
        for quant in (False, True):
            cfg = dataclasses.replace(entry.config, kv_quant=quant)
            specs += spec_leaves(TT.decode_cache_specs(cfg))
    return [None if s is None else list(s) for s in specs + ACTIVATIONS]


@pytest.fixture(scope="module")
def rule_cases():
    cases = []
    for arch in ARCHS:
        specs = _leaf_specs(arch)
        for mesh in MESHES.values():
            for _, shape, _ in [c for c in treg.cells(include_skipped=True)
                                if c[0] == arch]:
                for kw in VARIANTS:
                    cases.append(dict(kind="rules_for", arch=arch,
                                      shape=shape, kw=kw, mesh=mesh,
                                      specs=specs))
            for kw in ({}, {"fsdp": True}, {"seq_sharded": True},
                       {"fsdp": True, "seq_sharded": True}):
                cases.append(dict(kind="default", arch=arch, kw=kw,
                                  mesh=mesh, specs=specs))
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REF_RULES], cwd=ROOT,
                         env=env, input=json.dumps(cases), text=True,
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return cases, json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_spec_matches_reference(arch, rule_cases):
    cases, ref = rule_cases
    n = 0
    for case, want in zip(cases, ref):
        if case["arch"] != arch:
            continue
        rules = _port_rules(case)
        for s, w in zip(case["specs"], want):
            got = rules.spec(None if s is None else tuple(s))
            assert canon(got) == w, (case["kind"], case.get("shape"),
                                     case["kw"], case["mesh"], s)
            n += 1
    assert n > 0


def test_rules_tables_match_reference_on_stand_in_meshes():
    """The tables themselves (not only their specs): rules_for's per-cell
    table equals the reference's on a stand-in mesh for one LM, GNN and
    recsys cell, and the rows rule turns dp_model past 5e7 rows."""
    mesh = FakeMesh(*MESHES["multi"])
    dl = treg.get("dlrm-mlperf")
    r = TD.rules_for(mesh, dl, treg.get_shape("dlrm-mlperf", "serve_p99"), {})
    assert r.table["rows"] == ("pod", "data", "model")
    dcn = treg.get("dcn-v2")
    r = TD.rules_for(mesh, dcn, treg.get_shape("dcn-v2", "serve_p99"), {})
    assert r.table["rows"] == ("model",)
    g = treg.get("grok-1-314b")
    r = TD.rules_for(mesh, g, treg.get_shape("grok-1-314b", "decode_32k"), {})
    assert r.table["fsdp"] == ("pod", "data")      # 632 GB / 16 > 8e9
    r = TD.rules_for(mesh, treg.get("tinyllama-1.1b"),
                     treg.get_shape("tinyllama-1.1b", "long_500k"), {})
    assert r.table["batch"] is None and r.table["fsdp"] is None


def test_rules_validate_axis_names():
    mesh = FakeMesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="not in mesh axes"):
        TSH.Rules(mesh, {"batch": ("pod", "data")})
    with pytest.raises(ValueError):
        JSH.Rules(mesh, {"batch": ("pod", "data")})


def test_placements_per_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh((2, 4, 8), ("pod", "data", "model"))
    r = TSH.Rules(mesh, {"batch": ("pod", "data"), "model": "model",
                         "rows": ("data", "model")})
    assert r.placements(("batch", None, "model")) == (Shard(0), Shard(0),
                                                      Shard(2))
    # first dimension wins: 'data' went to batch, rows keeps 'model' only
    assert r.spec(("batch", "rows")) == (("pod", "data"), "model")
    assert r.placements(("batch", "rows")) == (Shard(0), Shard(0), Shard(1))
    assert r.placements(None) == (Replicate(),) * 3
    assert r.placements((None, None)) == (Replicate(),) * 3


def test_constrain_checks_rank_before_the_no_rules_return():
    x = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="rank-2"):
        TSH.constrain(x, "batch")
    assert TSH.constrain(x, "batch", None) is x
    one = TSH.default_rules(FakeMesh((1, 1), ("data", "model")))
    with TSH.use_rules(one):
        assert TSH.constrain(x, "batch", "model") is x
        with pytest.raises(ValueError):
            TSH.constrain(x, "batch", None, None)


def test_constrain_returns_plain_tensors_unchanged_under_rules():
    rules = TSH.default_rules(FakeMesh((16, 16), ("data", "model")))
    x = torch.zeros(4, 4)
    with TSH.use_rules(rules):
        assert TSH.constrain(x, "batch", "model") is x


def test_use_rules_nests_and_restores():
    a = TSH.default_rules(FakeMesh((2, 2), ("data", "model")))
    b = TSH.default_rules(FakeMesh((2, 2, 2), ("pod", "data", "model")))
    assert TSH.current_rules() is None
    with TSH.use_rules(a):
        assert TSH.current_rules() is a
        with TSH.use_rules(b) as got:
            assert got is b and TSH.current_rules() is b
            with TSH.use_rules(None):
                assert TSH.current_rules() is None
            assert TSH.current_rules() is b
        assert TSH.current_rules() is a
    assert TSH.current_rules() is None


def test_tree_shardings_keeps_namedtuples_as_containers():
    from torch.distributed.tensor import Replicate, Shard
    rules = TSH.default_rules(FakeMesh((2, 2), ("data", "model")))
    cfg = treg.get("gemma3-12b").config
    out = TSH.tree_shardings(rules, TT.decode_cache_specs(cfg))
    assert type(out) is TT.DecodeCache
    assert out.k == (Shard(1), Shard(2))          # batch, kv_seq
    assert out.k_loc == (Shard(1), Replicate())   # window: batch only
    assert out.k_sc == (Replicate(), Replicate())   # no int8 cache: None


REF_COLLECTIVES = textwrap.dedent("""
    from repro.dist.collectives import force_host_device_count
    force_host_device_count(4)
    import json
    import jax, numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    mesh = jax.make_mesh((4,), ("shard",))
    x = np.random.default_rng(3).standard_normal((4, 8, 12)).astype(
        np.float32)
    out = {}
    for split in (0, 1):
        for concat in (0, 1):
            f = shard_map(
                lambda a, s=split, c=concat: jax.lax.all_to_all(
                    a[0], "shard", s, c, tiled=True)[None],
                mesh=mesh, in_specs=P("shard"), out_specs=P("shard"))
            out[f"a2a {split} {concat}"] = np.asarray(f(x)).tolist()
    f = shard_map(lambda a: jax.lax.pmean(a, "shard"), mesh=mesh,
                  in_specs=P("shard"), out_specs=P("shard"))
    out["pmean"] = np.asarray(f(x)).tolist()
    out["x"] = x.tolist()
    print(json.dumps(out))
""")


def test_stacked_all_to_all_and_pmean_match_shard_map():
    """The stacked one-device family's ``all_to_all`` (every split and
    concat axis) and ``pmean`` are bit-equal to ``lax.all_to_all(tiled=
    True)`` and ``lax.pmean`` inside ``shard_map`` on 4 forced host
    devices (a subprocess, so this process keeps its one device)."""
    import numpy as np
    from repro_torch.dist import collectives as TC
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REF_COLLECTIVES], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    x = torch.tensor(ref["x"], dtype=torch.float32)
    for split in (0, 1):
        for concat in (0, 1):
            want = np.asarray(ref[f"a2a {split} {concat}"], np.float32)
            got = TC.all_to_all(x, split_axis=split, concat_axis=concat)
            assert tuple(got.shape) == want.shape
            np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(ref["pmean"], np.float32)
    got = TC.pmean(x)
    for s in range(4):        # every shard holds the mean
        np.testing.assert_array_equal(got.numpy(), want[s])
