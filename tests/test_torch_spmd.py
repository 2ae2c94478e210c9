"""Sharded steps on real ranks: the port's ``DTensor`` path over gloo CPU
ranks against the single-device steps, and elastic resharding of a
checkpoint (the reference's ``tests/test_elastic_reshard.py``).

* Four ranks on a (2, 2) data x model mesh run one LM train step at
  ``reduced_config("tinyllama-1.1b")`` (fp32) with every parameter laid
  out by ``default_rules(mesh, fsdp=True)`` and the tokens batch-sharded,
  under ``use_rules``, ``implicit_replication`` and ``Resharding`` (the
  heads' reshape of a 2-way sharded projection of one kv head replicates
  first).  The gathered parameters, loss and grad_norm are held within
  1e-5 of the port's single-device step and of the reference's jitted
  single-device step (its ``test_spmd_equivalence.py`` cannot run under
  the installed JAX, so the single-device steps are the oracles).
* The same four ranks run the process-group collectives by logical
  name (``mesh_psum``, ``mesh_pmean``, ``mesh_pmax``,
  ``mesh_all_gather``, ``mesh_all_to_all``; an unmapped name returns the
  tensor itself), each held bit-equal to the stacked one-device family
  over its group's ranks.
* Eight ranks save a checkpoint from a (2, 4) mesh and restore it onto a
  (4, 2) mesh with other placements (``restore(mesh=, placements=)``):
  equal values, the new placements, a shard on every rank, and zero
  first moments.

Each world is its own set of processes, so no process group outlives
its test.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jreg
from repro.train import steps as JS
from repro.train.optimizer import AdamW as JAdamW
from repro_torch.configs import registry as treg
from repro_torch.core import convert
from repro_torch.train import steps as TS
from repro_torch.train.optimizer import AdamW as TAdamW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10)
TOL = dict(rtol=1e-5, atol=1e-5)

STEP = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import registry
    from repro_torch.dist.sharding import (Resharding, default_rules,
                                           distribute_tree, tree_shardings,
                                           use_rules)
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T
    from repro_torch.train import steps as S, tree
    from repro_torch.train.optimizer import AdamW

    rank, port, src, dst = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                            sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    mesh = M.make_mesh((2, 2), ("data", "model"), "cpu")
    data = torch.load(src)
    cfg = registry.reduced_config("tinyllama-1.1b")
    rules = default_rules(mesh, fsdp=True)
    params = distribute_tree(data["params"], mesh,
                             tree_shardings(rules, T.lm_param_specs(cfg)))
    opt = AdamW(**data["opt"])
    tokens = distribute_tensor(data["tokens"], mesh,
                               rules.placements(("batch", None)))
    step = S.make_lm_train_step(cfg, opt, q_chunk=8)
    with use_rules(rules), implicit_replication(), Resharding():
        params, state, m = step(params, opt.init(params), tokens)

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    # the process-group family by logical name, on this rank's tensor
    from repro_torch.dist import collectives as C
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6) + 100 * rank
    with use_rules(rules):
        coll = {"psum": C.mesh_psum(x, "model"),
                "pmean": C.mesh_pmean(x, "batch"),
                "pmax": C.mesh_pmax(x, "model"),
                "gather": C.mesh_all_gather(x, "model", axis=1),
                "a2a": C.mesh_all_to_all(x, "model", split_axis=0,
                                         concat_axis=1),
                "size": C.axis_size("model"),
                "unmapped": C.mesh_psum(x, "seq") is x}
    every = [None] * 4
    dist.all_gather_object(every, coll)
    out = {"params": tree.tree_map(whole, params), "collectives": every,
           "placements": {"wq": [[type(p).__name__, getattr(p, "dim", None)]
                                 for p in params["layers"]["wq"].placements]},
           "loss": float(whole(m["loss"])),
           "grad_norm": float(whole(m["grad_norm"]))}
    if rank == 0:
        torch.save(out, dst)
    dist.destroy_process_group()
""")

RESHARD = textwrap.dedent("""
    import json, sys, torch, torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.dist.sharding import Rules
    from repro_torch.launch import mesh as M
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import AdamW

    rank, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=8)
    params = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
              "b": torch.ones(8)}
    state = AdamW().init(params)
    mesh_a = M.make_mesh((2, 4), ("data", "model"), "cpu")
    ra = Rules(mesh_a, {"data": "data", "model": "model"})
    params_a = {"w": distribute_tensor(params["w"], mesh_a,
                                       ra.placements(("data", "model"))),
                "b": distribute_tensor(params["b"], mesh_a,
                                       ra.placements(("model",)))}
    ck = CheckpointManager(d, keep=2)
    ck.save(7, params_a, state, extra={"mesh": "2x4"})
    dist.barrier()
    # restore onto a *different* mesh (as after elastic downsize)
    mesh_b = M.make_mesh((4, 2), ("data", "model"), "cpu")
    rb = Rules(mesh_b, {"data": "data", "model": "model"})
    pl_b = {"w": rb.placements(("model", "data")), "b": rb.placements(None)}
    step, p2, s2 = ck.restore_latest(params, state, mesh=mesh_b,
                                     placements=pl_b)
    w = p2["w"]
    has_shard = torch.tensor([int(w.to_local().numel() > 0)])
    dist.all_reduce(has_shard)
    res = {"step": step,
           "ok_vals": bool(torch.equal(w.full_tensor(), params["w"])),
           "ok_shard": (tuple(w.placements) == pl_b["w"]
                        and w.device_mesh == mesh_b
                        and tuple(w.to_local().shape) == (4, 2)),
           "n_shards": int(has_shard),
           "mu_ok": bool(torch.all(s2.mu["w"] == 0))}
    if rank == 0:
        print(json.dumps(res))
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _world(script: str, n: int, *args, timeout=240) -> str:
    """``script`` on ``n`` gloo ranks; rank 0's stdout."""
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), port, *map(str, args)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return outs[0][0]


def test_sharded_lm_train_step_matches_single_device(tmp_path):
    arch = "tinyllama-1.1b"
    jcfg, tcfg = jreg.reduced_config(arch), treg.reduced_config(arch)
    jp = JS.init_params_for(jreg.get(arch), jcfg, jax.random.key(0))
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                      "cpu")
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (4, 16),
                                             dtype=np.int32)
    torch.save({"params": tp, "opt": OPT, "tokens": torch.as_tensor(toks)},
               tmp_path / "in.pt")

    jopt, topt = JAdamW(**OPT), TAdamW(**OPT)
    jstep = jax.jit(JS.make_lm_train_step(jcfg, jopt, q_chunk=8))
    jp1, _, jm = jstep(jp, jopt.init(jp), jnp.asarray(toks))
    tp1, _, tm = TS.make_lm_train_step(tcfg, topt, q_chunk=8)(
        tp, topt.init(tp), torch.as_tensor(toks))

    _world(STEP, 4, tmp_path / "in.pt", tmp_path / "out.pt")
    got = torch.load(tmp_path / "out.pt")
    _check_mesh_collectives(got["collectives"])
    # wq is (fsdp, model): sharded over both mesh dims
    assert got["placements"]["wq"] == [["Shard", 1], ["Shard", 2]]
    for want in (float(tm["loss"]), float(jm["loss"])):
        np.testing.assert_allclose(got["loss"], want, **TOL)
    for want in (float(tm["grad_norm"]), float(jm["grad_norm"])):
        np.testing.assert_allclose(got["grad_norm"], want, rtol=1e-5)
    sharded = convert.params_to_numpy(got["params"])
    single = convert.params_to_numpy(tp1)
    ref = jax.tree.map(np.asarray, jp1)
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        keys = [getattr(k, "key", None) for k in path]
        s, t = sharded, single
        for k in keys:
            s, t = s[k], t[k]
        np.testing.assert_allclose(s, t, **TOL, err_msg=str(keys))
        np.testing.assert_allclose(s, leaf, **TOL, err_msg=str(keys))


def _check_mesh_collectives(every):
    """Each rank's results of the process-group family against the
    stacked one-device family over its group's ranks: on the (2, 2)
    mesh ranks [[0, 1], [2, 3]], 'model' groups {0, 1} and {2, 3},
    'batch' (data) groups {0, 2} and {1, 3}."""
    from repro_torch.dist import collectives as C

    def x(r):
        return torch.arange(24, dtype=torch.float32).reshape(4, 6) + 100 * r
    for r, got in enumerate(every):
        model = [r - r % 2, r - r % 2 + 1]
        data = [r % 2, r % 2 + 2]
        sm = torch.stack([x(q) for q in model])
        sd = torch.stack([x(q) for q in data])
        assert torch.equal(got["psum"], C.psum(sm))
        assert torch.equal(got["pmean"], C.pmean(sd))
        assert torch.equal(got["pmax"], C.pmax(sm))
        assert torch.equal(got["gather"], C.all_gather(sm, axis=1))
        assert torch.equal(got["a2a"], C.all_to_all(
            sm, split_axis=0, concat_axis=1)[model.index(r)])
        assert got["size"] == 2 and got["unmapped"] is True


def test_checkpoint_reshards_across_meshes(tmp_path):
    res = json.loads(_world(RESHARD, 8, tmp_path).strip().splitlines()[-1])
    assert res["step"] == 7
    assert res["ok_vals"], "values must survive the reshard"
    assert res["ok_shard"], "restored tensor must carry the new placements"
    assert res["n_shards"] == 8
    assert res["mu_ok"]
