"""Guards on the port's boundaries.

* No module of ``src/repro_torch`` — nor ``chip_smoke.py`` — imports
  ``jax`` or the reference package ``repro``: the port stands alone.
* The port's entry points run on the card by default and never drop to
  the CPU by themselves: asked for ``device="cuda"`` on a machine
  without CUDA they raise.
* The card-only check of each kernel against its plain version is
  marked ``cuda`` and skips without a card.
"""
import ast
import inspect
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.core import convert as tconv
from repro_torch.core import pointers as tp
from repro_torch.core import slicepool as tsp
from repro_torch.core import recovery as trec
from repro_torch.core.index import ActiveSegment
from repro_torch.core import sharded_index as tsh
from repro_torch.core.lifecycle import LifecycleEngine, ShardedLifecycleEngine
from repro_torch.core.qexec import FrozenStack
from repro_torch.core.segments import SegmentSet
from repro_torch.data import graph_sampler as tGS
from repro_torch.data import lm_data as tD
from repro_torch.kernels import embedding_bag as teb
from repro_torch.kernels.segment_intersect import decode_packed
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import recsys as tR
from repro_torch.models import schnet as tG
from repro_torch.models import transformer as tT
from repro_torch.paged import kv_cache as tkv
from repro_torch.paged import serve_model as tsm
from repro_torch.train import steps as tS
from repro_torch.train import tree as ttree

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


def test_guard_sees_every_port_module():
    names = {p.name for p in PORT_FILES}
    for must in ("lifecycle.py", "slicepool.py", "qexec.py", "ops.py",
                 "segment_intersect.py", "recovery.py", "chip_smoke.py",
                 "paged_attention.py", "kv_cache.py", "serve_model.py",
                 "serve.py", "transformer.py", "layers.py", "registry.py",
                 "embedding_bag.py", "recsys.py", "steps.py",
                 "time_embedding_bag.py", "time_segment_intersect.py",
                 "other_archs.py", "base.py", "invariants.py",
                 "sanitize.py", "faults.py", "policies.py", "history.py",
                 "tokenizer.py", "sharded_index.py", "collectives.py",
                 "moe.py", "lm_data.py", "tinyllama_1b.py", "gemma3_12b.py",
                 "deepseek_coder_33b.py", "qwen2_moe_a2_7b.py",
                 "grok_1_314b.py", "optimizer.py", "checkpoint.py",
                 "compression.py", "elastic.py", "tree.py", "train.py",
                 "schnet.py", "graph_sampler.py", "dcn_v2.py", "dien.py",
                 "dlrm_mlperf.py", "xdeepfm.py", "sharding.py",
                 "mesh.py", "roofline.py", "dryrun.py"):
        assert must in names


def test_entry_points_default_to_cuda():
    """Every constructor and loader defaults to the card; the scored
    methods run where the engine's tensors are."""
    for fn in (LifecycleEngine.__init__, ActiveSegment, SegmentSet,
               tsp.init_state, tsp.make_bulk_ingest_fn, decode_packed,
               FrozenStack, trec.restore, trec.recover,
               tkv.init_kv_state, tkv.make_append_fn, tkv.make_page_table_fn,
               tkv.make_tail_addr_fn, tsm.make_server, tT.init_lm,
               tT.init_decode_cache, tserve.serve, tconv.lm_params_from_numpy,
               tconv.kv_state_from_numpy, tS.make_recsys_forward,
               tS.make_recsys_retrieval_step, tS.init_params_for,
               tR.field_offsets, tconv.recsys_params_from_numpy,
               ShardedLifecycleEngine.__init__, tsh.make_doc_mesh,
               tsp.init_sharded_state, tD.make_batch_fn, tD.batches,
               tconv.opt_state_from_numpy, tG.init_schnet,
               tS.make_gnn_forward, tconv.gnn_params_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert 'add_argument("--device", default="cuda")' in \
        inspect.getsource(tserve.main)
    for fn in (tmesh.make_mesh, tmesh.make_production_mesh):
        assert inspect.signature(fn).parameters[
            "device_type"].default == "cuda"
    for name in ("scored_topk", "scored_topk_batch", "scored_full",
                 "scored_full_batch", "dispatch"):
        assert "device" not in inspect.signature(
            getattr(LifecycleEngine, name)).parameters


def test_cuda_request_without_cuda_raises(monkeypatch, tmp_path):
    """On a CUDA-less machine a CUDA engine raises instead of running on
    the CPU (and so do the lower entry points)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    layout = tp.PoolLayout(z=(1, 4), slices_per_pool=(8, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        LifecycleEngine(layout, 4, 10, max_slices=4, max_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedLifecycleEngine(layout, 4, 12, tsh.make_doc_mesh(4),
                               max_slices=4, max_len=8)
    snap = tmp_path / "e.snap"
    trec.snapshot(LifecycleEngine(layout, 4, 10, max_slices=4, max_len=8,
                                  device="cpu"), str(snap))
    trec.snapshot(ShardedLifecycleEngine(
        layout, 4, 12, tsh.make_doc_mesh(4, device="cpu"), max_slices=4,
        max_len=8, device="cpu"), str(tmp_path / "s.snap"))
    for fn in (trec.restore, trec.recover):
        for path in (snap, tmp_path / "s.snap"):
            with pytest.raises(RuntimeError, match="CUDA"):
                fn(str(path))
    if not torch.backends.cuda.is_built():
        with pytest.raises((AssertionError, RuntimeError)):
            ActiveSegment(layout, 4)


def test_recsys_entry_points_never_fall_back_to_the_cpu():
    """Asked for the card (the default) without CUDA, the recsys entry
    points raise; the kernel's wrapper raises on CPU tensors rather than
    run the plain version, and on a wrong dtype or a non-contiguous
    table; so does the bag's backward wrapper."""
    cfg = treg.reduced_config("dcn-v2")
    entry = treg.get("dcn-v2")
    if not torch.backends.cuda.is_built():
        for call in (lambda: tS.init_params_for(entry, cfg),
                     lambda: tS.make_recsys_forward(cfg),
                     lambda: tS.make_recsys_retrieval_step(cfg)):
            with pytest.raises((AssertionError, RuntimeError)):
                call()
    table = torch.zeros(8, 4)
    idx = torch.zeros(3, dtype=torch.int32)
    off = torch.tensor([0, 1, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        teb.embedding_bag(table, idx, off)
    with pytest.raises(ValueError, match="CUDA|contiguous"):
        teb.embedding_bag(table.t(), idx, off)
    # the backward kernel's wrapper refuses CPU tensors too
    with pytest.raises(ValueError, match="CUDA"):
        teb.embedding_bag_backward(torch.zeros(2, 4), idx, off, "sum", 8,
                                   torch.float32)
    # the recsys train step runs where the parameters are
    assert list(inspect.signature(tS.make_recsys_train_step).parameters) \
        == ["cfg", "opt", "n_microbatches"]


def test_gnn_entry_points_never_fall_back_to_the_cpu():
    """Asked for the card (the default) without CUDA, SchNet's init (by
    itself and through ``init_params_for``), the forward factory and the
    sampler's card sort raise; the train step runs where the parameters
    are."""
    cfg = treg.reduced_config("schnet")
    entry = treg.get("schnet")
    if not torch.backends.cuda.is_built():
        for call in (lambda: tG.init_schnet(cfg, torch.Generator(), 8),
                     lambda: tS.init_params_for(entry, cfg),
                     lambda: tS.init_params_for(
                         entry, cfg, shape_spec=treg.get_shape(
                             "schnet", "molecule")),
                     lambda: tS.make_gnn_forward(cfg),
                     lambda: tGS.random_graph(16, 2, device="cuda")):
            with pytest.raises((AssertionError, RuntimeError)):
                call()
    assert list(inspect.signature(tS.make_gnn_train_step).parameters) == \
        ["cfg", "opt", "n_graphs"]
    for fn in (tGS.CSRGraph.from_edges, tGS.random_graph):
        assert inspect.signature(fn).parameters["device"].default is None


def test_no_entry_point_waits_for_the_gnn_slice():
    """SchNet is in the registry and every GNN factory works: nothing
    left raises ``NotImplementedError`` naming Queue 1 item 12 parts 4
    or 7."""
    cfg = treg.get("schnet").config
    assert treg.get("schnet").family == "gnn"
    assert callable(tS.make_gnn_train_step(cfg, None))
    assert callable(tS.make_gnn_forward(cfg, device="cpu"))
    src = "\n".join(p.read_text(encoding="utf-8") for p in PORT_FILES)
    for part in ("part 4", "part 7", "12.4", "12.7"):
        assert f"item 12 {part}" not in src and f"item {part}" not in src


def test_no_module_waits_for_the_mesh_slice():
    """The mesh, sharding, dry-run and roofline slice is in: no docstring
    or comment of the port says anything waits for Queue 1 item 12 part
    6."""
    src = "\n".join(p.read_text(encoding="utf-8") for p in PORT_FILES)
    for s in ("12 part 6", "item 12.6", "12.6)", "for part 6",
              "wait on part 6"):
        assert s not in src, s


def test_rank_mesh_slice_is_scanned_and_waits_for_nothing():
    """The index on ranks is in: the import and docstring scans above
    cover every module it touched, and no docstring or comment of the
    port says the shard axis waits for a ``torch.distributed`` backend
    or keeps every shard in one process."""
    rel = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for must in ("src/repro_torch/core/sharded_index.py",
                 "src/repro_torch/dist/collectives.py",
                 "src/repro_torch/core/lifecycle.py",
                 "src/repro_torch/core/recovery.py",
                 "src/repro_torch/analysis/invariants.py",
                 "chip_smoke.py"):
        assert must in rel, must
    src = "\n".join(p.read_text(encoding="utf-8") for p in PORT_FILES)
    for s in ("backend for the shard axis", "keeps every shard in one",
              "Waiting for more than one card"):
        assert s not in src, s
    assert callable(tsh.make_rank_mesh)


def test_ranked_path_picks_no_backend_and_no_device_by_itself():
    """``process_world`` has no default backend; ``make_rank_mesh`` runs
    on the card unless asked for the CPU, and raises without one; a
    world is started only by ``dist/collectives.py`` (and the dry-run's
    one-card mesh), with the backend the caller names."""
    from repro_torch.dist import collectives as tcoll
    params = inspect.signature(tcoll.process_world).parameters
    assert params["backend"].default is inspect.Parameter.empty
    assert inspect.signature(tsh.make_rank_mesh).parameters[
        "device"].default == "cuda"
    users = sorted(p.relative_to(ROOT).as_posix() for p in PORT_FILES
                   if "init_process_group(" in p.read_text(encoding="utf-8"))
    assert users == ["src/repro_torch/dist/collectives.py",
                     "src/repro_torch/launch/dryrun.py"]


def test_ranked_recsys_slice_is_scanned():
    """The row-sharded bag is in: every module it touched is under the
    import scan above, and the ops docstring no longer says a sharded
    table on a real device reaches the kernel's wrapper as it is."""
    rel = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for must in ("src/repro_torch/kernels/ops.py",
                 "src/repro_torch/kernels/ref.py",
                 "src/repro_torch/kernels/embedding_bag.py",
                 "src/repro_torch/dist/collectives.py",
                 "src/repro_torch/train/optimizer.py",
                 "src/repro_torch/train/steps.py",
                 "src/repro_torch/models/recsys.py",
                 "src/repro_torch/launch/time_embedding_bag.py",
                 "chip_smoke.py"):
        assert must in rel, must
    from repro_torch.kernels import ops
    assert "still reaches the kernel's wrapper" not in ops.__doc__


def test_cuda_dtensor_table_without_a_card_raises(monkeypatch):
    """A row-sharded table whose tensors are taken for the card's goes to
    the kernel's wrapper, which raises without CUDA: the sharded route
    never drops to the plain version by itself."""
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.dist import collectives as tcoll
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "_on_cuda", lambda name, t: True)
    with tcoll.fake_world(1):
        mesh = tmesh.make_mesh((1,), ("model",), "cpu")
        table = DTensor.from_local(torch.zeros(8, 4), mesh, [Shard(0)],
                                   run_check=False)
        idx = torch.zeros(3, dtype=torch.int32)
        off = torch.tensor([0, 1, 3], dtype=torch.int32)
        with pytest.raises(ValueError, match="CUDA"):
            ops.embedding_bag(table, idx, off)


def test_fake_backend_imported_in_one_module():
    """``torch.testing._internal`` (private: the fake process group) is
    imported by ``dist/collectives.py`` alone."""
    users = [p.relative_to(ROOT).as_posix() for p in PORT_FILES
             if "torch.testing._internal" in p.read_text(encoding="utf-8")]
    assert users == ["src/repro_torch/dist/collectives.py"]


def test_dryrun_card_mesh_raises_without_cuda(monkeypatch):
    """``--mesh card`` is the card's own one-device mesh: without CUDA
    the CLI and the mesh factory raise, and no JSON line is printed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdry.main(["--arch", "xdeepfm", "--shape", "serve_p99", "--mesh",
                   "card", "--out", ""])
    with pytest.raises(RuntimeError, match="CUDA"):
        with tdry.mesh_for("card"):
            pass
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_lm_entry_points_never_fall_back_to_the_cpu(tmp_path):
    """Asked for the card (the default) without CUDA, the LM entry points
    raise for every registry LM (dense, local/global, MoE), and so does
    the training launcher; the prefill, decode and train steps run where
    the parameters are."""
    if not torch.backends.cuda.is_built():
        for arch in ("tinyllama-1.1b", "gemma3-12b", "qwen2-moe-a2.7b"):
            cfg = treg.reduced_config(arch)
            for call in (lambda: tT.init_lm(cfg),
                         lambda: tT.init_decode_cache(cfg, 1, 8),
                         lambda: tS.init_params_for(treg.get(arch), cfg),
                         lambda: tD.make_batch_fn(tD.LMDataConfig(
                             vocab=8, batch=1, seq_len=4))):
                with pytest.raises((AssertionError, RuntimeError)):
                    call()
    for fn in (tS.make_lm_prefill_step, tS.make_lm_decode_step,
               tS.make_lm_train_step, tS.make_recsys_train_step):
        assert "device" not in inspect.signature(fn).parameters
    # the training launcher defaults to the card and raises without one
    assert 'add_argument("--device", default="cuda")' in \
        inspect.getsource(ttrain.main)
    if not torch.backends.cuda.is_built():
        with pytest.raises((AssertionError, RuntimeError)):
            ttrain.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
        assert not list(tmp_path.iterdir())      # no checkpoint written
        # its deterministic mode ends with the run
        assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.cuda
def test_lm_paths_on_the_card_match_the_cpu():
    """``chip_smoke.py`` phase 9's checks at the reduced configs: each
    registry LM's forward, loss, prefill and decode (a ring past the
    window for Gemma3) on the card against the same weights on the CPU,
    fp32 with TF32 off (2e-4, the reference's LM tolerance); the int8
    cache's decode on the card against its exact decode as
    tests/test_kv_quant.py checks it (max |d| < 0.15, the last argmax
    equal); one MoE layer's grouped dispatch against its token path
    group by group (1e-5, the reference's MoE tolerance)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    from repro_torch.models import moe as tM
    tol = dict(rtol=2e-4, atol=2e-4)
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in ("tinyllama-1.1b", "gemma3-12b", "deepseek-coder-33b",
                 "qwen2-moe-a2.7b", "grok-1-314b"):
        cfg = treg.reduced_config(arch)
        cfgq = dataclasses.replace(cfg, kv_quant=True)
        cpu = tT.init_lm(cfg, seed=0, device="cpu")
        dev = tconv._map_tree(lambda a, key: a.to("cuda"), cpu)
        toks = torch.randint(0, cfg.vocab, (2, 24),
                             generator=torch.Generator().manual_seed(1))
        for fn in (tT.lm_forward, tT.lm_loss):
            torch.testing.assert_close(
                fn(dev, toks.cuda(), cfg, q_chunk=8).cpu(),
                fn(cpu, toks, cfg, q_chunk=8), **tol)
        (lc, cc), (lg, cg) = (tT.lm_prefill(p, t, cfg, q_chunk=8)
                              for p, t in ((cpu, toks), (dev, toks.cuda())))
        torch.testing.assert_close(lg.cpu(), lc, **tol)
        for a, b in zip(cg, cc):
            if b is not None:
                torch.testing.assert_close(a.cpu(), b, **tol)
        kc = tT.init_decode_cache(cfg, 2, 24, device="cpu")
        kg = tT.init_decode_cache(cfg, 2, 24, device="cuda")
        kq = tT.init_decode_cache(cfgq, 2, 24, device="cuda")
        qerr = 0.0
        for i in range(24):
            oc, kc = tT.lm_decode_step(cpu, kc, toks[:, i:i + 1], i, cfg)
            og, kg = tT.lm_decode_step(dev, kg, toks[:, i:i + 1].cuda(), i,
                                       cfg)
            oq, kq = tT.lm_decode_step(dev, kq, toks[:, i:i + 1].cuda(), i,
                                       cfgq)
            torch.testing.assert_close(og.cpu(), oc, **tol)
            qerr = max(qerr, float((oq - og).abs().max()))
        assert qerr < 0.15, (arch, qerr)
        assert torch.equal(oq.argmax(-1), og.argmax(-1)), arch
    cfg = treg.reduced_config("qwen2-moe-a2.7b")
    layer = tT.cast_layer(tT.unbind_layers(
        tT.init_lm(cfg, seed=2, device="cuda")["layers"])[0],
        torch.float32)["moe"]
    x = torch.randn(3, 16, cfg.d_model, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    y, m = tM.moe_ffn(x, layer, cfg)
    for g in range(3):
        torch.testing.assert_close(tM._moe_ffn_tokens(x[g], layer, cfg)[0],
                                   y[g], rtol=1e-5, atol=1e-5)
    assert float(m["drop_fraction"]) == 0.0


@pytest.mark.cuda
def test_gnn_paths_on_the_card_match_the_cpu():
    """``chip_smoke.py`` phase 11 (a) at the reduced config: SchNet's
    forward and one train step on the card against the same weights and
    graph on the CPU, fp32 with TF32 off (1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.train.optimizer import AdamW
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = treg.reduced_config("schnet")
    rng = np.random.default_rng(0)
    N, E, F = 50, 200, 16
    batch = dict(
        node_feat=torch.as_tensor(rng.normal(size=(N, F)),
                                  dtype=torch.float32),
        src=torch.as_tensor(rng.integers(0, N, E), dtype=torch.int32),
        dst=torch.as_tensor(rng.integers(0, N, E), dtype=torch.int32),
        edge_dist=torch.as_tensor(rng.uniform(0, 10, E),
                                  dtype=torch.float32),
        graph_id=torch.zeros(N, dtype=torch.int32),
        targets=torch.ones(1))
    cpu = tG.init_schnet(cfg, torch.Generator().manual_seed(0), F,
                         device="cpu")
    dev = tconv._map_tree(lambda a, key: a.to("cuda"), cpu)
    gpu_batch = {k: v.cuda() for k, v in batch.items()}
    tol = dict(rtol=1e-5, atol=1e-5)
    for got, want in zip(tS.make_gnn_forward(cfg)(dev, gpu_batch),
                         tS.make_gnn_forward(cfg, device="cpu")(cpu, batch)):
        torch.testing.assert_close(got.cpu(), want, **tol)
    opt = AdamW()
    step = tS.make_gnn_train_step(cfg, opt)
    pg, sg, mg = step(dev, opt.init(dev), gpu_batch)
    pc, sc, mc = step(cpu, opt.init(cpu), batch)
    torch.testing.assert_close(mg["loss"].cpu(), mc["loss"], **tol)
    for g, c in zip(ttree.leaves(pg), ttree.leaves(pc)):
        torch.testing.assert_close(g.cpu(), c, **tol)


@pytest.mark.cuda
def test_bag_gradient_on_the_card_matches_autograd():
    """``table.grad`` through the CUDA bag (forward and backward kernels)
    equals the plain version's autograd gradient on the CPU: bit for bit
    on rows with one contribution, within 1e-5 of each row's summed
    magnitudes elsewhere; bit-equal from run to run; one backward launch
    a call; a bf16 table's gradient is the fp32 sum cast once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(4)
    R, D, B = 300, 16, 200
    for mode in ("sum", "mean"):
        lens = rng.integers(0, 9, B)
        off = np.concatenate([[2], 2 + np.cumsum(lens)]).astype(np.int32)
        idx = (rng.zipf(1.3, int(off[-1]) + 3) % (R + 40) - 20
               ).astype(np.int32)
        g = rng.normal(size=(B, D)).astype(np.float32)
        cpu = torch.as_tensor(rng.normal(size=(R, D)).astype(np.float32))
        grads = []
        for dev in ("cpu", "cuda", "cuda"):
            t = cpu.detach().to(dev).requires_grad_(True)
            ops.reset_launch_counts()
            out = ops.embedding_bag(t, torch.as_tensor(idx, device=dev),
                                    torch.as_tensor(off, device=dev), mode)
            (out * torch.as_tensor(g, device=dev)).sum().backward()
            if dev == "cuda":
                assert ops.launch_counts()["embedding_bag_backward"] == 1
            grads.append(t.grad.cpu())
        want, got, again = grads
        assert torch.equal(got, again)
        pos = np.arange(idx.size)
        inside = (pos >= off[0]) & (pos < off[-1])
        rows = np.clip(idx, 0, R - 1)[inside]
        single = torch.as_tensor(np.bincount(rows, minlength=R) == 1)
        assert torch.equal(got[single], want[single])
        mag = ref.embedding_bag_backward_ref(
            torch.as_tensor(np.abs(g)), torch.as_tensor(idx),
            torch.as_tensor(off), mode, R, torch.float32)
        assert bool(((got - want).abs() <= 1e-5 * mag).all())
        bf = ops.embedding_bag_backward(
            torch.as_tensor(g, device="cuda"),
            torch.as_tensor(idx, device="cuda"),
            torch.as_tensor(off, device="cuda"), mode, R, torch.bfloat16)
        assert bf.dtype == torch.bfloat16
        assert torch.equal(bf.cpu()[single], want.to(torch.bfloat16)[single])


@pytest.mark.cuda
def test_windowed_bag_kernels_match_plain_versions_on_the_card():
    """The row window (a table sharded by rows): at S = 2 and 4 windows,
    fp32 and bf16, sum and mean, ids clipped at both ends, empty bags and
    positions outside [offsets[0], offsets[B]): each window's forward
    kernel bit-equal to the windowed in-order sum (and to the windowed
    plain version on single-row bags), the windows summing to the whole
    kernel's bags within 1e-5; each window's backward kernel, the blocks
    concatenated, bit-equal to the whole table's backward kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ref
    from repro_torch.launch import time_embedding_bag as tbag
    rng = np.random.default_rng(9)
    R, D, B = 4096, 16, 300
    for dt in (torch.float32, torch.bfloat16):
        table = torch.randn(R, D).to(dt).cuda()
        for lens in (rng.integers(0, 40, B), np.ones(B, np.int64)):
            off = np.concatenate([[3], 3 + np.cumsum(lens)]).astype(np.int32)
            idx = (rng.zipf(1.2, int(off[-1]) + 4) % (R + 40) - 20
                   ).astype(np.int32)
            idx = torch.as_tensor(idx).cuda()
            off = torch.as_tensor(off).cuda()
            g = torch.randn(B, D).cuda()
            for mode in ("sum", "mean"):
                whole = eb.embedding_bag(table, idx, off, mode)
                bwd = eb.embedding_bag_backward(g, idx, off, mode, R, dt)
                for S in (2, 4):
                    parts, blocks = [], []
                    for k in range(S):
                        lo, hi = k * R // S, (k + 1) * R // S
                        got = eb.embedding_bag(table[lo:hi], idx, off, mode,
                                               row_lo=lo, row_hi=hi,
                                               num_rows=R)
                        assert torch.equal(got, tbag.in_order_bags(
                            table[lo:hi], idx, off, mode, row_lo=lo,
                            row_hi=hi, num_rows=R))
                        if (lens == 1).all():
                            assert torch.equal(got, ref.embedding_bag_ref(
                                table[lo:hi], idx, off, mode, row_lo=lo,
                                row_hi=hi, num_rows=R))
                        parts.append(got)
                        blocks.append(eb.embedding_bag_backward(
                            g, idx, off, mode, R, dt, row_lo=lo, row_hi=hi))
                    total = sum(parts[1:], parts[0])
                    if (lens == 1).all():
                        assert torch.equal(total, whole)
                    torch.testing.assert_close(total, whole, rtol=1e-5,
                                               atol=1e-5)
                    assert torch.equal(torch.cat(blocks), bwd)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """Each CUDA kernel against its plain version on small random
    inputs (bit-identical).  Runs where a card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.segment_intersect import (pack_docids,
                                                       stack_packed)
    rng = np.random.default_rng(0)
    dev = "cuda"
    ids = [np.unique(rng.integers(0, s, n)).astype(np.uint32)
           for n, s in ((0, 10), (129, 300), (800, 70000), (500, 1 << 30))]
    a = stack_packed([pack_docids(x) for x in ids]).to(dev)
    b = stack_packed([pack_docids(x) for x in ids[::-1]]).to(dev)
    assert torch.equal(ops.segment_intersect_mask_batched(a, b),
                       ref.segment_intersect_mask_batched_ref(a, b))
    p, q = pack_docids(ids[2]).to(dev), pack_docids(ids[1]).to(dev)
    assert torch.equal(ops.segment_intersect_mask(p, q),
                       ref.segment_intersect_mask_ref(p, q))
    # the frozen-segment kernels' edge cases (block firsts, lasts and gaps,
    # 128 b-blocks for one a-block, wide windows, many a-blocks on one
    # b-block, mixed widths, empty rows and lists, NB 1 and 4,096, 1 and
    # 64 rows, extreme docids), batched and as single pairs, each twice
    from repro_torch.kernels import segment_intersect as si
    from repro_torch.launch import time_segment_intersect as tsg
    for name, a_, b_ in tsg.edge_stacks(si, device=dev):
        want = ref.segment_intersect_mask_batched_ref(a_, b_)
        for _ in range(2):
            assert torch.equal(ops.segment_intersect_mask_batched(a_, b_),
                               want), name
    for name, p_, q_ in tsg.edge_pairs(si, device=dev):
        want = ref.segment_intersect_mask_ref(p_, q_)
        for _ in range(2):
            assert torch.equal(ops.segment_intersect_mask(p_, q_), want), name
    x = torch.full((2, 512), 0xFFFFFFFF, dtype=torch.int64, device=dev)
    y = x.clone()
    x[:, :300] = torch.arange(0, 600, 2)
    y[:, :400] = torch.arange(0, 1200, 3)
    assert torch.equal(ops.intersect_mask(x, y), ref.intersect_mask_ref(x, y))
    # the redesigned kernel's edge cases (runs straddling its 4,096-element
    # tiles, empty prefixes, equal, disjoint, extreme values, rows) and
    # the three max_len = 2**23 pairs, each twice and bit-equal
    from repro_torch.launch import time_intersect_mask as tim
    cases = [(f"{n} ({t})", torch.from_numpy(a).to(dev),
              torch.from_numpy(b).to(dev))
             for t in (7, 64, 4096) for n, a, b in tim.edge_cases(t)]
    cases += tim.full_width_shapes(*tim.segment_lists(), device=dev)
    for name, p_, q_ in cases:
        want = ref.intersect_mask_ref(p_, q_)
        for _ in range(2):
            assert torch.equal(ops.intersect_mask(p_, q_), want), name
    layout = tp.PoolLayout(z=(1, 4, 7, 11), slices_per_pool=(64, 32, 16, 8))
    st = tsp.init_state(layout, 8, dev)
    ingest = tsp.make_bulk_ingest_fn(layout, 8, dev)
    terms = torch.as_tensor(rng.integers(0, 8, 300), device=dev)
    scat, _, _, _ = ingest.plan(st, terms, torch.arange(300, device=dev),
                                torch.zeros_like(terms),
                                torch.ones(300, dtype=torch.bool,
                                           device=dev))
    k = [t.clone() for t in (st.heap, st.tail, st.freq)]
    r = [t.clone() for t in (st.heap, st.tail, st.freq)]
    ops.bulk_append(*k, *scat)
    ref.bulk_append_ref(*r, *scat)
    for g, w in zip(k, r):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_checked_routes_launch_the_kernels_on_the_card():
    """``checked=True`` on CUDA tensors launches (and counts) the kernel
    and equals the unchecked call; a seeded out-of-range window raises
    ``SanitizerError`` before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.analysis import sanitize
    from repro_torch.kernels import ops
    from repro_torch.kernels.segment_intersect import (pack_docids,
                                                       stack_packed)
    rng = np.random.default_rng(3)
    ids = [np.unique(rng.integers(0, 1 << 20, n)).astype(np.uint32)
           for n in (900, 300)]
    a = stack_packed([pack_docids(x) for x in ids]).to("cuda")
    b = stack_packed([pack_docids(x) for x in ids[::-1]]).to("cuda")
    want = ops.segment_intersect_mask_batched(a, b)
    ops.reset_launch_counts()
    got = ops.segment_intersect_mask_batched(a, b, checked=True)
    assert ops.launch_counts()["segment_intersect_mask_batched"] == 1
    assert torch.equal(got, want)
    with pytest.raises(sanitize.SanitizerError, match="woffs"):
        ops.segment_intersect_mask_batched(
            a._replace(woffs=a.woffs + 10_000), b, checked=True)
    assert ops.launch_counts()["segment_intersect_mask_batched"] == 1


@pytest.mark.cuda
def test_scored_kernel_matches_plain_version_on_the_card():
    """The scored CUDA kernel against its plain version, bit for bit, at
    thresholds that skip no block, some blocks and every block, and on
    the edge cases of ``launch/time_segment_intersect.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.segment_intersect import (pack_scored,
                                                       stack_scored)
    rng = np.random.default_rng(1)

    def lists(seed):
        r = np.random.default_rng(seed)
        out = []
        for n, span in ((0, 10), (129, 400), (900, 70000), (700, 1 << 30),
                        (300, 900)):
            ids = np.unique(r.integers(0, span, n)).astype(np.uint32)
            out.append(pack_scored(ids, r.integers(1, 256, ids.size)))
        return out
    a = stack_scored(lists(2)).to("cuda")
    b = stack_scored(lists(3)[::-1]).to("cuda")
    rows = a.bmax.shape[0]
    rest = torch.as_tensor(rng.integers(0, 100, rows), dtype=torch.int32,
                           device="cuda")
    for th_v in (-1, 200, 400):
        th = torch.full((rows,), th_v, dtype=torch.int32, device="cuda")
        got = ops.scored_intersect_batched(a, b, rest, th)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.scored_intersect_batched_ref(
            a, b, rest, th))
    # the edge cases at three thresholds each (255 + 255 hits, b impacts
    # of 0, a bound that wraps in int32), each twice
    from repro_torch.kernels import segment_intersect as si
    from repro_torch.launch import time_segment_intersect as tsg
    for name, a_, b_, r_, t_ in tsg.scored_edge_cases(si, device="cuda"):
        want = ref.scored_intersect_batched_ref(a_, b_, r_, t_)
        for _ in range(2):
            assert torch.equal(ops.scored_intersect_batched(a_, b_, r_, t_),
                               want), name


@pytest.mark.cuda
def test_paged_attention_kernel_matches_plain_version_on_the_card():
    """The paged-attention CUDA kernel against its plain version: fp32
    and bf16 heaps, D from 8 to 256 (shared memory past 48 KB; D % 16 ==
    8 and G > 8 take the SIMT P.V and a second head group), lengths
    at page edges, 0, and longer than the table; B = 1 rows of 2048+
    tokens and lengths at the split edges; every registry LM head shape
    (G in {1, 2, 6, 7, 8}, D in {64, 128, 256}); two calls on the
    same inputs bit-equal (a split-order merge, counters that reset);
    and the kernel against the plain split-and-merge at its own split."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as tpa
    rng = np.random.default_rng(2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def check(B, Hkv, G, D, dt, lens, NP, pages, pad_row0=False):
        table = torch.as_tensor(
            rng.permutation(pages)[:B * NP].reshape(B, NP), dtype=torch.int32)
        if pad_row0:
            table[0, 1:] = -1
        q = torch.randn(B, Hkv, G, D).to(dt)
        kh = torch.randn(Hkv, pages * 64, D).to(dt)
        vh = torch.randn(Hkv, pages * 64, D).to(dt)
        args = [t.cuda() for t in (q, kh, vh, table,
                                   torch.as_tensor(lens, dtype=torch.int32))]
        got = ops.paged_attention(*args)
        again = ops.paged_attention(*args)
        torch.cuda.synchronize()
        want = ref.paged_attention_ref(*args)
        assert got.dtype == torch.float32
        assert float((got - want).abs().max()) <= 1e-4, (B, Hkv, G, D, dt)
        assert torch.equal(got, again)
        # the plain split-and-merge at the split the wrapper picks
        split = tpa.split_plan(B, Hkv, G, NP, sms)
        mirror = ref.paged_attention_split_ref(*args, *split)
        assert float((got - mirror).abs().max()) <= 1e-4, (B, G, D, split)
        return got

    for (B, Hkv, G, D), dt in (((3, 2, 4, 8), torch.float32),
                               ((5, 4, 8, 64), torch.bfloat16),
                               ((2, 1, 8, 256), torch.float32),
                               ((4, 2, 2, 128), torch.bfloat16),
                               ((3, 2, 3, 8), torch.bfloat16),
                               ((4, 1, 12, 24), torch.bfloat16),
                               ((2, 3, 9, 40), torch.float32)):
        got = check(B, Hkv, G, D, dt, [64, 0, 65, 3 * 64 + 7, 1][:B], 3, 40,
                    pad_row0=True)
        assert not got[1].any()
    # B = 1 prefill rows, 2048+ tokens, at the split edges
    NP = 2148 // 64 + 1
    S, pps = tpa.split_plan(1, 4, 8, NP, sms)
    edge = pps * 64
    for n in (1, 64, 65, edge - 1, edge, edge + 1, 2047, 2048, 2148, 4000):
        for dt in (torch.float32, torch.bfloat16):
            check(1, 4, 8, 64, dt, [n], NP, 64)
    # every registry LM head shape, B = 1 and B = 32
    for arch in ("tinyllama-1.1b", "gemma3-12b", "deepseek-coder-33b",
                 "qwen2-moe-a2.7b", "grok-1-314b"):
        cfg = treg.get(arch).config
        Hkv, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
        for B in (1, 32):
            lens = list(rng.integers(0, 8 * 64 + 30, B))
            for dt in (torch.float32, torch.bfloat16):
                check(B, Hkv, G, cfg.d_head, dt, lens, 8, 8 * 32 + 8)


@pytest.mark.cuda
def test_embedding_bag_kernel_matches_plain_version_on_the_card():
    """The embedding-bag CUDA kernel against its plain version: fp32 and
    bf16 tables at the recsys widths D in {1, 10, 16, 18, 128}, bags of
    0 to 64 rows, all-empty bags, N = 0, ids out of range (clipped), sum
    and mean; bags of one row bit-identical to the table's rows.  Then
    the kernel's edge cases (bags longer than a chunk and across its
    tiles, offsets[0] > 0, a malformed CSR, table views at odd rows and
    elements) and the ten path shapes at 100,000 rows: each call twice,
    bit-equal, and bit-equal to the in-order sum on every bag."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(3)
    for D in (1, 10, 16, 18, 128):
        for dt in (torch.float32, torch.bfloat16):
            R = 1000
            table = torch.randn(R, D).to(dt).cuda()
            for lens in (rng.integers(0, 65, 300), np.zeros(7, np.int64),
                         np.zeros(0, np.int64), np.ones(500, np.int64)):
                off = np.zeros(len(lens) + 1, np.int32)
                off[1:] = np.cumsum(lens)
                idx = torch.as_tensor(rng.integers(-50, R + 50, off[-1]),
                                      dtype=torch.int32).cuda()
                off = torch.as_tensor(off).cuda()
                for mode in ("sum", "mean"):
                    got = ops.embedding_bag(table, idx, off, mode)
                    torch.cuda.synchronize()
                    want = ref.embedding_bag_ref(table, idx, off, mode)
                    assert got.dtype == torch.float32
                    assert got.shape == (len(lens), D)
                    if (lens == 1).all():
                        assert torch.equal(
                            got, table[idx.long().clamp(0, R - 1)].float())
                    torch.testing.assert_close(got, want, rtol=1e-5,
                                               atol=1e-5)
    from repro_torch.launch import time_embedding_bag as tbag
    for name, table, idx, off, mode in (tbag.edge_cases(seed=3)
                                        + tbag.path_shapes(seed=3)):
        got = ops.embedding_bag(table, idx, off, mode)
        assert torch.equal(got, ops.embedding_bag(table, idx, off, mode))
        assert torch.equal(got, tbag.in_order_bags(table, idx, off, mode)), \
            name
        lo, hi = tbag.bag_bounds(off, idx.numel())
        one = (hi - lo) == 1
        assert torch.equal(got[one], table[idx.long()[lo[one]].clamp(
            0, table.shape[0] - 1)].float()), name
