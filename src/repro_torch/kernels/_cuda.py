"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Every source is compiled by ``nvcc`` for ``sm_90a`` into an object, all
at once (one process each), and linked into ONE shared library with a
plain C interface that ctypes loads.  The build runs at first use, into
``src/repro_torch/_build/`` (listed in ``.gitignore``), and is keyed by a
hash of the sources and flags, so an edited kernel rebuilds and an
unchanged one loads in milliseconds.  Nothing here runs at import time:
the CPU tests import every module of the port without a CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
# C signature of every entry point: pointers and the stream as void*,
# sizes as int64; each returns the launch's cudaError_t.
_SIGNATURES = {
    "bulk_append_launch": [_P, _I64, _P, _P, _I64, _P, _P, _P, _P, _P, _P,
                           _P, _I64, _I64, _I64, _I64, _P],
    "intersect_mask_launch": [_P, _P, _P, _I64, _I64, _I64, _P],
    "segment_intersect_launch": [_P, _P, _P, _P, _P, _I64, _I64,
                                 _P, _P, _P, _P, _P, _I64, _I64,
                                 _P, _I64, _P],
    "scored_intersect_launch": [_P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                                _P, _P, _P, _P, _P, _P, _I64, _I64,
                                _P, _P, _P, _I64, _P],
    "paged_attention_launch": [_P, _I64, _P, _P, _I64, _P, _P, _P, _P, _P,
                               _I64, _I64, _I64, _I64, _I64, _I64, _I64,
                               _I64, _P],
    "embedding_bag_launch": [_P, _I64, _P, _I64, _P, _I64, _I64, _I64,
                             _I64, _I64, _I64, _I64, _I64, _I64, _I64, _P,
                             _P],
    "embedding_bag_backward_keys": [_P, _P, _I64, _I64, _I64, _I64, _I64,
                                    _P, _P, _P, _P, _I64, _P],
    "embedding_bag_backward_launch": [_P, _I64, _I64, _P, _P, _P, _P, _P,
                                      _I64, _I64, _I64, _I64, _I64, _I64,
                                      _I64, _P, _P, _P, _P, _P, _P, _P,
                                      _P, _P],
}

_state = {"lib": None, "build_s": None}


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None and Path("/usr/local/cuda/bin/nvcc").exists():
        exe = "/usr/local/cuda/bin/nvcc"
    if exe is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from "
            "src/repro_torch/csrc at first use and need the CUDA toolkit")
    return exe


def _build(out: Path, sources) -> None:
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        logs = [p.communicate()[0].decode(errors="replace") for p in procs]
        for src, p, log in zip(sources, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        staged = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
             str(staged)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(staged, out)   # atomic: a reader never sees half a lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    if _state["lib"] is not None:
        return _state["lib"]
    t0 = time.perf_counter()
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"
    if not out.exists():
        _build(out, sources)
    cdll = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _state["lib"] = cdll
    _state["build_s"] = time.perf_counter() - t0
    return cdll


def build_seconds() -> float:
    """Wall time of the first :func:`lib` call (build or load)."""
    lib()
    return _state["build_s"]


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


_sms = {}             # device index -> SM count


def sm_count(device) -> int:
    """The SM count of a CUDA ``device`` (read once per device)."""
    import torch
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def require_cuda(name: str, *tensors) -> None:
    """Every operand of a CUDA kernel lies on one CUDA device and is
    contiguous: the wrapper raises rather than copy or fall back."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: every operand must be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
