"""Port vs reference: ``CheckpointManager`` (``train/checkpoint.py``) and
the restart runner (``train/elastic.py``).

* A checkpoint either package writes restores bit-equal in the other:
  parameters and ``AdamWState`` (DCN-v2's ``reduced_config`` tree, whose
  MLPs are lists), and a ``CompressedState`` (``opt_state/inner/...``,
  ``opt_state/residual/...``); the files hold the same leaf names,
  shapes and dtypes.
* A bf16 checkpoint the reference writes (bf16 leaves as ``V2``)
  restores bit-equal in the port; the reference's own restore raises on
  it (``src/repro/train/checkpoint.py:51``).  The port writes bf16 as
  the same bits.
* keep-k, the manifest, ``restore(device=)``, a missing leaf and a
  shape mismatch; the reference's restart test
  (``tests/test_train_runtime.py``) on the port's ``TrainLoopRunner``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.train import compression as JC
from repro.train import optimizer as JO
from repro.train import steps as JS
from repro.train.checkpoint import CheckpointManager as JCkpt
from repro_torch.configs import registry as treg
from repro_torch.core import convert
from repro_torch.data import lm_data as TD
from repro_torch.train import compression as TC
from repro_torch.train import elastic as TE
from repro_torch.train import optimizer as TO
from repro_torch.train import tree
from repro_torch.train.checkpoint import CheckpointManager as TCkpt


def _bits(x):
    """Raw bytes of a leaf (bf16 by its bit pattern)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    a = np.asarray(x)
    return (a.view(np.int16) if a.dtype == jnp.bfloat16 else a).tobytes()


def _same(jt, tt):
    jl = jax.tree.leaves(jt)
    tl = tree.leaves(tt)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(np.shape(j)) == tuple(t.shape)
        assert _bits(j) == _bits(t)


def _dcn(dtype="float32", steps=2):
    """DCN-v2 reduced parameters and an AdamW state after ``steps``
    reference updates, in both packages."""
    import dataclasses
    jcfg = dataclasses.replace(jreg.reduced_config("dcn-v2"),
                               param_dtype=dtype)
    tcfg = dataclasses.replace(treg.reduced_config("dcn-v2"),
                               param_dtype=dtype)
    jp = JS.init_params_for(jreg.get("dcn-v2"), jcfg, jax.random.PRNGKey(3))
    opt = JO.AdamW(lr=1e-2, warmup_steps=1)
    js = opt.init(jp)
    for i in range(steps):
        g = jax.tree.map(lambda p: jnp.full(p.shape, 0.01 * (i + 1),
                                            p.dtype), jp)
        jp, js = opt.update(g, js, jp)
    tp = convert.recsys_params_from_numpy(jax.tree.map(np.asarray, jp),
                                          tcfg, "cpu")
    ts = convert.opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    return (jp, js), (tp, ts)


def test_reference_checkpoint_restores_in_port(tmp_path):
    (jp, js), (tp, ts) = _dcn()
    JCkpt(str(tmp_path)).save(7, jp, js, extra={"loss": 0.5})
    zero_p = tree.tree_map(torch.zeros_like, tp)
    zero_s = tree.tree_map(torch.zeros_like, ts)
    step, p, s = TCkpt(str(tmp_path)).restore_latest(zero_p, zero_s)
    assert step == 7
    assert isinstance(s, TO.AdamWState) and s.step.dtype == torch.int32
    _same(jp, p)
    _same(js, s)
    assert isinstance(p["mlp"], list)


def test_port_checkpoint_restores_in_reference(tmp_path):
    (jp, js), (tp, ts) = _dcn()
    TCkpt(str(tmp_path)).save(9, tp, ts, extra={"loss": 0.25})
    zp = jax.tree.map(jnp.zeros_like, jp)
    zs = jax.tree.map(jnp.zeros_like, js)
    step, p, s = JCkpt(str(tmp_path)).restore_latest(zp, zs)
    assert step == 9 and int(s.step) == 2
    _same(p, tp)
    _same(s, ts)
    with open(tmp_path / "MANIFEST.json") as fh:
        assert json.load(fh) == {"latest_step": 9, "extra": {"loss": 0.25}}


def test_files_hold_the_same_leaves(tmp_path):
    (jp, js), (tp, ts) = _dcn()
    JCkpt(str(tmp_path / "j")).save(1, jp, js)
    TCkpt(str(tmp_path / "t")).save(1, tp, ts)
    with np.load(tmp_path / "j" / "step_00000001.npz") as a, \
            np.load(tmp_path / "t" / "step_00000001.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert "opt_state/mu/mlp/0/w" in a.files
        for k in a.files:
            assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), k
            assert a[k].tobytes() == b[k].tobytes(), k


def test_compressed_state_crosses_packages(tmp_path):
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(6, 4)).astype(np.float32),
              "b": [rng.normal(size=4).astype(np.float32)]}
    jopt = JC.CompressedAdamW(JO.AdamW(lr=1e-2, warmup_steps=1))
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    jp, js = jopt.update(jax.tree.map(lambda p: p * 0.3 + 0.01, jp), js, jp)
    JCkpt(str(tmp_path)).save(1, jp, js)
    ts_like = TC.CompressedAdamW(TO.AdamW()).init(
        tree.tree_map(torch.as_tensor, params))
    tp_like = tree.tree_map(torch.as_tensor, params)
    _, p, s = TCkpt(str(tmp_path)).restore_latest(tp_like, ts_like)
    assert isinstance(s, TC.CompressedState)
    _same(jp, p)
    _same(js, s)
    with np.load(tmp_path / "step_00000001.npz") as z:
        assert {"opt_state/inner/step", "opt_state/residual/b/0",
                "opt_state/inner/mu/w"} <= set(z.files)
    TCkpt(str(tmp_path / "back")).save(2, p, s)
    _, p2, s2 = JCkpt(str(tmp_path / "back")).restore_latest(jp, js)
    _same(p2, p)
    _same(s2, s)


def test_bf16_checkpoint_restores_in_port_where_reference_raises(tmp_path):
    (jp, js), (tp, ts) = _dcn("bfloat16")
    assert jp["table"].dtype == jnp.bfloat16 and js.mu["table"].dtype == \
        jnp.bfloat16
    JCkpt(str(tmp_path)).save(3, jp, js)
    with pytest.raises(ValueError, match="cast"):
        JCkpt(str(tmp_path)).restore_latest(jp, js)
    with np.load(tmp_path / "step_00000003.npz") as z:
        assert z["params/table"].dtype == np.dtype("V2")
    zp = tree.tree_map(torch.zeros_like, tp)
    zs = tree.tree_map(torch.zeros_like, ts)
    step, p, s = TCkpt(str(tmp_path)).restore_latest(zp, zs)
    assert step == 3 and p["table"].dtype == torch.bfloat16
    _same(jp, p)
    _same(js, s)
    # the port writes bf16 as the reference does: the same bytes
    TCkpt(str(tmp_path / "t")).save(3, p, s)
    with np.load(tmp_path / "step_00000003.npz") as a, \
            np.load(tmp_path / "t" / "step_00000003.npz") as b:
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), k


def test_keep_k_manifest_and_restore_errors(tmp_path):
    params = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    state = TO.AdamW().init(params)
    mgr = TCkpt(str(tmp_path), keep=2)
    assert mgr.latest_step() is None
    assert mgr.restore_latest(params, state) == (None, None, None)
    for s in (10, 20, 30):
        mgr.save(s, params, state, extra={"s": s})
    assert mgr.all_steps() == [20, 30]
    assert sorted(os.listdir(tmp_path)) == [
        "MANIFEST.json", "step_00000020.npz", "step_00000030.npz"]
    with open(tmp_path / "MANIFEST.json") as fh:
        assert json.load(fh) == {"latest_step": 30, "extra": {"s": 30}}
    step, p, o = mgr.restore_latest(params, state, device="cpu")
    assert step == 30 and torch.equal(p["w"], params["w"])
    assert int(o.step) == 0 and o.step.dtype == torch.int32
    p, o = mgr.restore(20, params)
    assert o is None and p["w"].device.type == "cpu"
    with pytest.raises(KeyError, match="missing leaf v"):
        mgr.restore(30, {"w": params["w"], "v": params["w"]})
    with pytest.raises(ValueError, match="shape mismatch for w"):
        mgr.restore(30, {"w": torch.zeros(3, 2)})


def test_checkpoint_restart_bit_identical(tmp_path):
    """The reference's restart test on the port: train 20 steps, crash
    at 13, resume from the step-10 checkpoint and replay: final
    parameters identical to the uninterrupted run."""
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.normal(size=(64, 8)), dtype=torch.float32)
    y = X @ torch.as_tensor(rng.normal(size=(8,)), dtype=torch.float32)
    params0 = {"w": torch.zeros(8)}
    opt = TO.AdamW(lr=0.05, warmup_steps=2, total_steps=100,
                   weight_decay=0.0)
    batch_fn = TD.make_batch_fn(TD.LMDataConfig(vocab=50, batch=4,
                                                seq_len=8), device="cpu")

    def loss_fn(p):
        return torch.mean((X @ p["w"] - y) ** 2)

    def step_fn(params, opt_state, batch):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(
            loss_fn({"w": w}) * (1 + 1e-4 * batch.float().mean()), [w])
        params, opt_state = opt.update({"w": g}, opt_state, params)
        return params, opt_state, {"loss": loss_fn(params)}

    def run(ckpt_dir, fail_at=None):
        runner = TE.TrainLoopRunner(step_fn, TCkpt(ckpt_dir, keep=5),
                                    save_every=5)
        params, opt_state = params0, opt.init(params0)
        try:
            return runner.run(params, opt_state,
                              [batch_fn(s) for s in range(20)],
                              start_step=0, fail_at=fail_at)
        except RuntimeError as e:
            assert "injected failure at step 13" in str(e)
            start, params, opt_state = runner.resume(params, opt_state)
            assert start == 10
            return runner.run(params, opt_state,
                              [batch_fn(s) for s in range(start, 20)],
                              start_step=start)

    s1, p_clean, o_clean = run(str(tmp_path / "clean"))
    s2, p_crash, o_crash = run(str(tmp_path / "crash"), fail_at=13)
    assert s1 == s2 == 20
    assert torch.equal(p_clean["w"], p_crash["w"])
    for a, b in zip(tree.leaves(o_clean), tree.leaves(o_crash)):
        assert torch.equal(a, b)
    runner = TE.TrainLoopRunner(step_fn, TCkpt(str(tmp_path / "none")))
    assert runner.resume(params0, "st") == (0, params0, "st")
