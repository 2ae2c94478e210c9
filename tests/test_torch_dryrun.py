"""The port's dry-run (``launch/dryrun.py``): a step traced on ``meta``
tensors over fake ranks, counted per device.

* A reduced config of each family (dense LM, MoE LM, SchNet, recsys
  train, serve and retrieval) on a (2, 2) fake mesh gives one record
  with every key the reference's ``run_cell`` writes, the port's model
  FLOPs, and counts that are positive where work was done.
* The probe's two-depth extrapolation equals a full-depth trace exactly
  in FLOPs, bytes, wire bytes and argument bytes (dense, local/global
  and MoE stacks); the peak of temporaries within 5%.
* The spec trees fit the parameter trees (paths and ranks) at
  ``reduced_config`` and at the published widths (on ``meta``).
* Sharding the batch over two ranks halves a batch-parallel step's
  per-device FLOPs.
* The CLI prints one JSON line with ``"ok": true`` on a CPU-only box,
  and the sweep runs one subprocess per cell.

Every trace runs in this process inside ``fake_world``, which destroys
its process group on exit; the CLI and the sweep run in subprocesses.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.dist import sharding as TSH
from repro_torch.launch import dryrun as TD
from repro_torch.launch import roofline as RL
from repro_torch.models import transformer as TT
from repro_torch.train import steps as TS
from repro_torch.train import tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_KEYS = {
    "arch", "shape", "mesh", "flops_per_dev", "bytes_per_dev",
    "wire_bytes_per_dev", "model_flops", "n_devices", "per_device_mem",
    "t_compute", "t_memory", "t_collective", "bottleneck",
    "roofline_fraction", "useful_flop_ratio", "collectives", "notes",
    "bytes_per_dev_raw", "variant", "overrides", "t_lower_s",
    "t_compile_s", "memory_analysis", "ok"}
MEM_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes"}


# LM cells at a short length (the override the card's phases use too)
SHORT = dict(global_batch=8, seq_len=64, q_chunk=32)


@pytest.mark.parametrize("arch,shape,ov", [
    ("tinyllama-1.1b", "train_4k", SHORT),
    ("qwen2-moe-a2.7b", "decode_32k", dict(seq_len=64)),
    ("gemma3-12b", "prefill_32k", SHORT), ("schnet", "molecule", {}),
    ("dcn-v2", "train_batch", {}), ("xdeepfm", "serve_p99", {}),
    ("dien", "retrieval_cand", {})])
def test_reduced_cell_has_every_reference_key(arch, shape, ov):
    r = TD.run_cell(arch, shape, "single", ov, mesh_shape_=(2, 2),
                    reduced=True)
    assert REF_KEYS <= set(r) and r["ok"] is True
    assert set(r["memory_analysis"]) == MEM_KEYS
    assert r["n_devices"] == 4 and r["mesh"] == "single"
    assert r["model_flops"] == RL.model_flops_for(
        arch, shape, treg.get(arch), TD.cell_spec(arch, shape, ov))
    assert r["flops_per_dev"] > 0 and r["bytes_per_dev"] > 0
    assert r["per_device_mem"] >= r["memory_analysis"][
        "argument_size_in_bytes"] > 0
    assert set(r["collectives"]["bytes"]) <= set(RL.COLLECTIVES)
    assert r["wire_bytes_per_dev"] == sum(r["collectives"]["bytes"].values())
    assert r["bottleneck"] in ("compute", "memory", "collective")
    json.dumps(r)


@pytest.mark.parametrize("arch,n_layers", [
    ("tinyllama-1.1b", 4), ("gemma3-12b", 8), ("qwen2-moe-a2.7b", 4)])
def test_probe_extrapolation_equals_the_full_trace(arch, n_layers):
    ov = dict(global_batch=4, seq_len=32, q_chunk=32, n_microbatches=1,
              n_layers=n_layers)
    full = TD.run_cell(arch, "train_4k", "single", ov, mesh_shape_=(2, 2),
                       reduced=True)
    probe = TD.run_cell(arch, "train_4k", "single", dict(ov, probe=True),
                        mesh_shape_=(2, 2), reduced=True)
    assert "extrapolated" in probe["notes"]
    for k in ("flops_per_dev", "bytes_per_dev", "wire_bytes_per_dev"):
        assert probe[k] == full[k], k
    args = "argument_size_in_bytes"
    assert probe["memory_analysis"][args] == full["memory_analysis"][args]
    # the peak of temporaries is a max over the step, linear in L only
    # piecewise: extrapolated, not exact
    assert probe["per_device_mem"] == pytest.approx(full["per_device_mem"],
                                                    rel=0.05)


def _fits(params, specs):
    got = {p: tuple(t.shape) for p, t in tree.items_with_path(params)}
    flat = {}

    def walk(node, path):
        if TSH.is_spec_leaf(node):
            flat[path] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        else:
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
    walk(specs, ())
    assert set(flat) == set(got)
    for path, shape in got.items():
        assert flat[path] is not None and len(flat[path]) == len(shape), path


@pytest.mark.parametrize("arch", list(treg.ARCHS))
def test_spec_trees_fit_the_parameter_trees(arch):
    entry = treg.get(arch)
    for cfg in (treg.reduced_config(arch), entry.config):
        params = TS.init_params_for(entry, cfg, device="meta")
        _fits(params, TS.param_specs_for(entry, cfg))
        if entry.family == "lm":
            for quant in (False, True):
                c = cfg.__class__(**{**cfg.__dict__, "kv_quant": quant})
                cache = TT.init_decode_cache(c, 2, 64, device="meta")
                specs = TT.decode_cache_specs(c)
                for f in cache._fields:
                    t, s = getattr(cache, f), getattr(specs, f)
                    assert (t is None) == (s is None), f
                    if t is not None:
                        assert len(s) == t.dim(), f


def test_batch_sharding_halves_a_data_parallel_step():
    one = TD.run_cell("dcn-v2", "serve_bulk", "single", {},
                      mesh_shape_=(1, 1), reduced=True)
    two = TD.run_cell("dcn-v2", "serve_bulk", "single", {},
                      mesh_shape_=(2, 1), reduced=True)
    assert one["n_devices"] == 1 and two["n_devices"] == 2
    assert one["wire_bytes_per_dev"] == 0
    assert 0.45 < two["flops_per_dev"] / one["flops_per_dev"] < 0.55


def test_no_process_group_outlives_a_cell():
    import torch.distributed as dist
    TD.run_cell("xdeepfm", "serve_p99", "single", {}, mesh_shape_=(2, 1),
                reduced=True)
    assert not dist.is_initialized()


def _env():
    return dict(os.environ, PYTHONPATH="src")


def test_cli_prints_one_ok_json_line():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "xdeepfm", "--shape", "serve_p99", "--mesh", "single", "--out",
         ""], cwd=ROOT, env=_env(), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert r["ok"] is True and REF_KEYS <= set(r) and r["n_devices"] == 256


def test_sweep_runs_a_subprocess_per_cell(tmp_path, monkeypatch):
    cells = [("xdeepfm", "serve_p99", False), ("nope", "serve_p99", False)]
    monkeypatch.setattr(TD.registry, "cells", lambda: iter(cells))
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("PYTHONPATH", "src")
    out = tmp_path / "sweep.jsonl"
    rc = TD.main(["--all", "--meshes", "single", "--jobs", "2", "--out",
                  str(out)])
    assert rc == 1                          # the unknown arch failed
    recs = {r["arch"]: r for r in map(json.loads,
                                      out.read_text().splitlines())}
    assert recs["xdeepfm"]["ok"] is True
    assert recs["nope"]["ok"] is False and "unknown arch" in \
        recs["nope"]["error"]


def test_fake_world_require_devices_and_host_mesh():
    """``fake_world(n)`` is a world of n ranks for the dry-run alone:
    ``require_devices`` reads its size and spells out the fix when it is
    short, ``host_mesh`` builds a mesh over it, a second world is refused
    and none outlives the context."""
    import torch.distributed as dist
    from repro_torch.dist import collectives as C
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="fake_world\\(4\\)"):
            C.require_devices(4)
    with C.fake_world(4):
        C.require_devices(4)
        with pytest.raises(RuntimeError, match="need 8 ranks, have 4"):
            C.require_devices(8)
        mesh = C.host_mesh((2, 2), ("data", "model"))
        assert TSH.mesh_shape(mesh) == {"data": 2, "model": 2}
        assert mesh.device_type == "cpu"
        with pytest.raises(RuntimeError, match="already exists"):
            with C.fake_world(2):
                pass
    assert not dist.is_initialized()
