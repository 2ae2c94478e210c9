"""Three-term roofline of one step on one NVIDIA H100 (the reference's
``launch/roofline.py``):

    compute    = flops_per_device / peak FLOP/s of the step's dtype
    memory     = bytes_per_device / HBM bandwidth
    collective = wire_bytes_per_device / NVLink bandwidth

The counts come from ``repro_torch.launch.dryrun``, which traces the
step on ``meta`` tensors over a fake world: FLOPs and bytes of every op
a device runs on its own shard, and the wire bytes of every collective
``DTensor`` issues (:func:`wire_bytes`, fed by the dry-run's dispatch
mode with each collective's kind, output bytes and group size).  The
reference parses them out of compiled HLO text; the port has no HLO, so
no parser.

Constants: NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit.
A :class:`Roofline` names the peak it used (``peak``): ``bf16`` (989
TFLOP/s) for the LMs' bf16 steps, ``fp32`` (67 TFLOP/s, off the tensor
cores) where a step runs fp32 with TF32 off (the recsys and SchNet steps
as the card runs them), ``tf32`` (495 TFLOP/s) where TF32 is on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

# --- NVIDIA H100 SXM (per card; dense; at 700 W) ---------------------------
PEAK_FLOPS = 989e12          # bf16 / fp16 on the tensor cores
PEAK_FLOPS_TF32 = 495e12     # fp32 inputs through TF32 tensor cores
PEAK_FLOPS_FP32 = 67e12      # fp32 outside the tensor cores
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s each way per card (NVLink 4, 18 links)

PEAKS = {"bf16": PEAK_FLOPS, "tf32": PEAK_FLOPS_TF32,
         "fp32": PEAK_FLOPS_FP32}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def peak_for(dtype_name: str, tf32: bool = False) -> str:
    """The key of :data:`PEAKS` a step computing in ``dtype_name`` runs
    at: ``bf16`` for bfloat16/float16, else ``tf32`` or ``fp32``."""
    if dtype_name in ("bfloat16", "float16"):
        return "bf16"
    return "tf32" if tf32 else "fp32"


def shape_bytes(shape, dtype: torch.dtype) -> int:
    """Bytes of a tensor of ``shape`` and ``dtype``."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=dtype).element_size()


def wire_bytes(kind: str, out_bytes: int, group: int) -> int:
    """Bytes each participant puts on the wire for one collective over a
    ring of ``group`` ranks, from the bytes of its output:

      all-gather          out * (g-1)/g    (out = the gathered buffer)
      reduce-scatter      out * (g-1)      (in = out * g)
      all-reduce          2 * out * (g-1)/g
      all-to-all          out * (g-1)/g
      collective-permute  out              (point-to-point)
    """
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}")
    if group <= 1:
        return 0
    frac = (group - 1) / group
    if kind == "all-gather":
        return int(out_bytes * frac)
    if kind == "reduce-scatter":
        return int(out_bytes * (group - 1))
    if kind == "all-reduce":
        return int(2 * out_bytes * frac)
    if kind == "all-to-all":
        return int(out_bytes * frac)
    return out_bytes


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: int = 0                      # per-device bytes on the wire
    op_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    op_count: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, kind: str, b: int):
        self.wire_bytes += b
        self.op_bytes[kind] = self.op_bytes.get(kind, 0) + b
        self.op_count[kind] = self.op_count.get(kind, 0) + 1

    def record(self, kind: str, out_bytes: int, group: int):
        """One collective: its ring bytes (a group of one is no
        collective and is not counted, as the reference skips it)."""
        if group > 1:
            self.add(kind, wire_bytes(kind, out_bytes, group))


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops: float                 # per-device flops
    hlo_bytes: float             # per-device bytes of every op's operands
    wire_bytes: float            # per-device collective wire bytes
    model_flops: float           # global useful flops (6ND etc.)
    n_devices: int
    per_device_mem: int          # argument (+ reckoned temporary) bytes
    collective_detail: dict
    notes: str = ""
    peak: str = "bf16"           # key of PEAKS the compute term uses

    @property
    def peak_flops(self) -> float:
        return PEAKS[self.peak]

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.wire_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / max(three terms): 1.0 = at the roofline."""
        t_useful = (self.model_flops / self.n_devices) / self.peak_flops
        t_bound = self.t_bound
        return t_useful / t_bound if t_bound > 0 else 0.0

    @property
    def useful_flop_ratio(self) -> float:
        flops_global = self.flops * self.n_devices
        return self.model_flops / flops_global if flops_global else 0.0

    def mfu(self, seconds: float) -> float:
        """Measured share: model FLOPs per device over (``seconds`` x
        the peak)."""
        return (self.model_flops / self.n_devices) / (seconds
                                                      * self.peak_flops)

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "flops_per_dev": self.flops, "bytes_per_dev": self.hlo_bytes,
            "wire_bytes_per_dev": self.wire_bytes,
            "model_flops": self.model_flops, "n_devices": self.n_devices,
            "per_device_mem": self.per_device_mem,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "roofline_fraction": self.roofline_fraction,
            "useful_flop_ratio": self.useful_flop_ratio,
            "collectives": self.collective_detail,
            "notes": self.notes,
            "peak": self.peak, "peak_flops": self.peak_flops,
        }


def model_flops_for(arch: str, shape_name: str, entry, spec) -> float:
    """Useful-work FLOPs: 6*N*D train / 2*N*D inference (active params)."""
    fam = entry.family
    cfg = entry.config
    if fam == "lm":
        n_active = cfg.active_param_count
        if spec.kind == "train":
            tokens = spec.global_batch * spec.seq_len
            return 6.0 * n_active * tokens
        if spec.kind == "prefill":
            tokens = spec.global_batch * spec.seq_len
            return 2.0 * n_active * tokens
        # decode: one token per sequence + attention reads over the cache.
        # local/global archs only read the window for local layers.
        tokens = spec.global_batch
        if cfg.local_global_ratio:
            r = cfg.local_global_ratio
            n_glob = cfg.n_layers // (r + 1)
            n_loc = cfg.n_layers - n_glob
            l_eff = (n_loc * min(cfg.sliding_window, spec.seq_len)
                     + n_glob * spec.seq_len)
        else:
            l_eff = cfg.n_layers * spec.seq_len
        attn = 4.0 * l_eff * cfg.n_heads * cfg.d_head * tokens
        return 2.0 * n_active * tokens + attn
    if fam == "gnn":
        n, e = spec.extra("n_nodes", 0), spec.extra("n_edges", 0)
        if spec.name == "minibatch_lg":
            b = spec.extra("batch_nodes")
            f1, f2 = spec.extra("fanout")
            n = b + b * f1 + (b + b * f1) * f2
            e = b * f1 + (b + b * f1) * f2
        if spec.name == "molecule":
            n, e = 30 * spec.extra("batch"), 64 * spec.extra("batch")
        d = cfg.d_hidden
        per_edge = 2.0 * (cfg.n_rbf * d + 2 * d * d)
        per_node = 2.0 * 4 * d * d
        return 3.0 * cfg.n_interactions * (e * per_edge + n * per_node)
    # recsys: embedding bytes dominate; FLOPs = MLP + interaction
    B = spec.global_batch
    if spec.kind == "retrieval":
        return 2.0 * spec.extra("n_candidates") * cfg.embed_dim
    d = cfg.embed_dim
    f = cfg.n_sparse
    flops = 0.0
    dims_in = f * d + cfg.n_dense
    if cfg.interaction == "dot":
        flops += f * f * d
        dims_in = cfg.bot_mlp[-1] + f * (f - 1) // 2
    elif cfg.interaction == "cross":
        flops += 3 * 2 * cfg.n_cross_layers * dims_in * dims_in
    elif cfg.interaction == "cin":
        prev = f
        for h in cfg.cin_layers:
            flops += 2 * prev * f * d * h
            prev = h
        dims_in = sum(cfg.cin_layers)
    elif cfg.interaction == "augru":
        flops += cfg.seq_len * 2 * 3 * (2 * d + cfg.gru_dim) * cfg.gru_dim
        dims_in = 2 * d + cfg.gru_dim
    mlps = list(cfg.bot_mlp) + [dims_in] + list(cfg.top_mlp) + [1]
    for a, b in zip(mlps[:-1], mlps[1:]):
        flops += 2 * a * b
    mult = 3.0 if spec.kind == "train" else 1.0
    return mult * B * flops


def format_row(r: Roofline) -> str:
    return (f"{r.arch:<20s} {r.shape:<14s} {r.mesh:<6s} "
            f"c={r.t_compute * 1e3:9.3f}ms m={r.t_memory * 1e3:9.3f}ms "
            f"w={r.t_collective * 1e3:9.3f}ms "
            f"bound={r.bottleneck:<10s} frac={r.roofline_fraction:6.3f} "
            f"useful={r.useful_flop_ratio:5.2f}")
