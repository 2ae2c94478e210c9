"""Port vs reference: the launch layer's units (the reference's
``tests/test_launch.py``): mesh helpers, the ring formulas, model FLOPs,
the roofline's terms on the H100's constants, and the registry's cells
and dry-run overrides.

The reference's collective bytes come from parsing HLO text; the port
has no HLO, so its ring formula (``roofline.wire_bytes``) is fed the
(kind, output bytes, group size) of each collective in the reference
test's HLO module and must give the reference's per-kind bytes, counts
and total.
"""
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import roofline as JRL
from repro.launch.mesh import batch_axes_for as j_batch_axes_for
from repro_torch.configs import registry as treg
from repro_torch.launch import mesh as TM
from repro_torch.launch import roofline as RL


class FakeMesh:
    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


def test_batch_axes_for_divisible():
    mesh = FakeMesh((2, 16, 16), ("pod", "data", "model"))
    assert TM.batch_axes_for(mesh, 256) == ("pod", "data")
    assert TM.batch_axes_for(mesh, 32) == ("pod", "data")
    assert TM.batch_axes_for(mesh, 16) == ("data",)
    assert TM.batch_axes_for(mesh, 2) == ("pod",)
    assert TM.batch_axes_for(mesh, 1) is None


@pytest.mark.parametrize("shape,axes", [
    ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
    ((4, 2), ("data", "model")), ((3, 4, 2), ("pod", "data", "model"))])
def test_batch_axes_for_and_dp_extent_match_reference(shape, axes):
    mesh = FakeMesh(shape, axes)
    for b in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 256, 512, 65_536):
        assert TM.batch_axes_for(mesh, b) == j_batch_axes_for(mesh, b), b
    want = mesh.shape["data"] * mesh.shape.get("pod", 1)
    assert TM.dp_extent(mesh) == want


def test_production_mesh_shapes():
    assert TM.PRODUCTION[False] == ((16, 16), ("data", "model"))
    assert TM.PRODUCTION[True] == ((2, 16, 16), ("pod", "data", "model"))


HLO = """
HloModule jit_step

ENTRY %main (p0: f32[64,128]) -> f32[64,128] {
  %p0 = f32[64,128]{1,0} parameter(0)
  %ag = f32[64,2048]{1,0} all-gather(%p0), replica_groups=[32,16]<=[512], dimensions={1}
  %ar = f32[64,128]{1,0} all-reduce(%p0), replica_groups={{0,1,2,3},{4,5,6,7}}, to_apply=%add
  %rs = f32[64,8]{1,0} reduce-scatter(%p0), replica_groups=[32,16]<=[512], dimensions={1}
  %cp = f32[64,128]{1,0} collective-permute(%p0), source_target_pairs={{0,1}}
  %a2 = f32[64,128]{1,0} all-to-all(%p0), replica_groups=[64,8]<=[512], dimensions={0}
  ROOT %out = f32[64,128]{1,0} add(%ar, %cp)
}
"""
# the same collectives as (kind, output shape, group size): what the
# dry-run's dispatch mode records for a functional collective
CALLS = [("all-gather", (64, 2048), 16), ("all-reduce", (64, 128), 4),
         ("reduce-scatter", (64, 8), 16),
         ("collective-permute", (64, 128), 512),
         ("all-to-all", (64, 128), 8)]


def test_ring_formulas_match_the_reference_parser():
    ref = JRL.collective_bytes(HLO, n_devices=512)
    st = RL.CollectiveStats()
    for kind, shape, g in CALLS:
        st.record(kind, RL.shape_bytes(shape, torch.float32), g)
    assert st.op_bytes == ref.op_bytes
    assert st.op_count == ref.op_count
    assert st.wire_bytes == ref.wire_bytes
    b = 64 * 128 * 4
    assert st.op_bytes["all-gather"] == int(64 * 2048 * 4 * 15 / 16)
    assert st.op_bytes["all-reduce"] == int(2 * b * 3 / 4)
    assert st.op_bytes["reduce-scatter"] == 64 * 8 * 4 * 15
    assert st.op_bytes["collective-permute"] == b


@pytest.mark.parametrize("kind", RL.COLLECTIVES)
@pytest.mark.parametrize("g", [1, 2, 3, 16])
def test_wire_bytes_per_kind_and_group(kind, g):
    out = 4096
    got = RL.wire_bytes(kind, out, g)
    if g == 1:
        assert got == 0
        st = RL.CollectiveStats()
        st.record(kind, out, g)
        assert st.op_count == {} and st.wire_bytes == 0
        return
    frac = (g - 1) / g
    want = {"all-gather": int(out * frac), "all-to-all": int(out * frac),
            "reduce-scatter": out * (g - 1),
            "all-reduce": int(2 * out * frac),
            "collective-permute": out}[kind]
    assert got == want


def test_wire_bytes_refuses_unknown_kinds():
    with pytest.raises(ValueError):
        RL.wire_bytes("broadcast", 8, 2)


def test_shape_bytes_over_torch_dtypes():
    assert RL.shape_bytes((128, 1024), torch.bfloat16) == 128 * 1024 * 2
    assert RL.shape_bytes((10,), torch.float32) == 40
    assert RL.shape_bytes((7,), torch.bool) == 7
    assert RL.shape_bytes((), torch.int64) == 8
    assert RL.shape_bytes((3, 0), torch.float32) == 0


@pytest.mark.parametrize("arch,shape",
                         [(a, s) for a, s, _ in
                          treg.cells(include_skipped=True)])
def test_model_flops_match_reference(arch, shape):
    got = RL.model_flops_for(arch, shape, treg.get(arch),
                             treg.get_shape(arch, shape))
    want = JRL.model_flops_for(arch, shape, jreg.get(arch),
                               jreg.get_shape(arch, shape))
    assert got == want


def test_model_flops_lm_train_scale():
    entry = treg.get("tinyllama-1.1b")
    spec = treg.get_shape("tinyllama-1.1b", "train_4k")
    f = RL.model_flops_for("tinyllama-1.1b", "train_4k", entry, spec)
    assert 5e15 < f < 9e15


def test_model_flops_moe_uses_active_params():
    entry = treg.get("qwen2-moe-a2.7b")
    spec = treg.get_shape("qwen2-moe-a2.7b", "train_4k")
    f = RL.model_flops_for("qwen2-moe-a2.7b", "train_4k", entry, spec)
    assert f < 6.0 * entry.config.param_count * 4096 * 256 / 2


def test_roofline_terms_on_h100_constants():
    assert (RL.PEAK_FLOPS, RL.PEAK_FLOPS_TF32, RL.PEAK_FLOPS_FP32,
            RL.HBM_BW, RL.NVLINK_BW) == (989e12, 495e12, 67e12, 3.35e12,
                                         450e9)
    r = RL.Roofline(arch="a", shape="s", mesh="single",
                    flops=989e12, hlo_bytes=3.35e12 * 2, wire_bytes=450e9,
                    model_flops=989e12 * 256 * 0.5, n_devices=256,
                    per_device_mem=0, collective_detail={})
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(2.0)
    assert r.t_collective == pytest.approx(1.0)
    assert r.bottleneck == "memory"
    assert r.roofline_fraction == pytest.approx(0.25)
    assert r.useful_flop_ratio == pytest.approx(0.5)
    assert r.mfu(2.0) == pytest.approx(0.25)
    f32 = RL.Roofline(arch="a", shape="s", mesh="card", flops=67e12,
                      hlo_bytes=0, wire_bytes=0, model_flops=67e12,
                      n_devices=1, per_device_mem=0, collective_detail={},
                      peak="fp32")
    assert f32.t_compute == pytest.approx(1.0)
    assert f32.bottleneck == "compute"
    d = f32.to_dict()
    assert d["peak"] == "fp32" and d["peak_flops"] == 67e12
    assert set(JRL.Roofline(**{k: getattr(r, k) for k in (
        "arch", "shape", "mesh", "flops", "hlo_bytes", "wire_bytes",
        "model_flops", "n_devices", "per_device_mem",
        "collective_detail")}).to_dict()) <= set(d)
    assert RL.format_row(r).split()[:3] == ["a", "s", "single"]


def test_peak_for_dtypes():
    assert RL.peak_for("bfloat16") == "bf16"
    assert RL.peak_for("float16") == "bf16"
    assert RL.peak_for("float32") == "fp32"
    assert RL.peak_for("float32", tf32=True) == "tf32"


def test_registry_cells_skips_and_overrides_match_reference():
    assert list(treg.cells()) == list(jreg.cells())
    assert list(treg.cells(include_skipped=True)) == \
        list(jreg.cells(include_skipped=True))
    assert len(list(treg.cells(include_skipped=True))) == 40
    assert len(list(treg.cells())) == 36
    for arch in treg.ARCHS:
        te, je = treg.get(arch), jreg.get(arch)
        assert (te.skip_shapes, te.skip_reason) == (je.skip_shapes,
                                                    je.skip_reason)
        for s in te.shapes:
            assert treg.overrides(arch, s.name) == \
                jreg.overrides(arch, s.name)
    assert treg.DRYRUN_OVERRIDES == jreg.DRYRUN_OVERRIDES
    got = treg.overrides("gemma3-12b", "train_4k")
    got["q_chunk"] = 1
    assert treg.overrides("gemma3-12b", "train_4k")["q_chunk"] == 512
