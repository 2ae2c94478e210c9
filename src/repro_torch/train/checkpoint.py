"""Fault-tolerant checkpointing (the reference's ``train/checkpoint.py``):
atomic writes, keep-last-k, a manifest.

Layout:  <dir>/step_00001234.npz  +  <dir>/MANIFEST.json
Writes go to a tmp file + atomic ``os.replace``, so a failure mid-save
never corrupts the latest checkpoint.  Leaves are named by their tree
paths as the reference names them (``params/...``, ``opt_state/step``,
``opt_state/mu/...``, ``opt_state/inner/...``,
``opt_state/residual/...``; list indices ``0``, ``1``, ...), so a file
either package writes restores in the other.

bf16 leaves are written as the reference writes them: their 16-bit
pattern as numpy's void type ``V2``.  On restore a ``V2`` array read
into a bf16 template is taken back as those bits; the reference's
restore raises on it (``arr.astype(bfloat16)`` has no cast from ``V2``),
so only the port restores a bf16 checkpoint.  ``restore(device=)``
takes the place of the reference's ``shardings=``: there is one device.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.train import tree as T

def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:          # the reference's bits, as V2
        return t.contiguous().view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor, device) -> torch.Tensor:
    dev = like.device if device is None else device
    if like.dtype == torch.bfloat16 and arr.dtype.kind == "V":
        bits = np.ascontiguousarray(arr).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(dev)
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        arr = np.array(arr)
    return torch.from_numpy(arr).to(device=dev, dtype=like.dtype)


def _flatten(tree) -> dict:
    return {"/".join(path): _to_numpy(leaf)
            for path, leaf in T.items_with_path(tree)}


def _unflatten(template, flat: dict, device=None):
    out = []
    for path, like in T.items_with_path(template):
        key = "/".join(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {arr.shape} vs "
                f"template {tuple(like.shape)}")
        out.append(_from_numpy(arr, like, device))
    return T.unflatten(template, out)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, params, opt_state=None, extra: dict = None):
        payload = {"params": params}
        if opt_state is not None:
            payload["opt_state"] = opt_state
        flat = _flatten(payload)
        fname = os.path.join(self.directory, f"step_{step:08d}.npz")
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                np.savez(fh, **flat)
            os.replace(tmp, fname)      # atomic on POSIX
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self._write_manifest(step, extra or {})
        self._gc()
        return fname

    def _write_manifest(self, step: int, extra: dict):
        man = {"latest_step": step, "extra": extra}
        tmp = os.path.join(self.directory, "MANIFEST.tmp")
        with open(tmp, "w") as fh:
            json.dump(man, fh)
        os.replace(tmp, os.path.join(self.directory, "MANIFEST.json"))

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            os.unlink(os.path.join(self.directory, f"step_{s:08d}.npz"))

    # -- restore ------------------------------------------------------------
    def all_steps(self):
        out = []
        for f in os.listdir(self.directory):
            if f.startswith("step_") and f.endswith(".npz"):
                out.append(int(f[5:-4]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, params_template, opt_template=None,
                device=None) -> Tuple[Any, Any]:
        """Restore onto templates (their tree, shapes and dtypes), each
        leaf on ``device`` or, by default, on its template leaf's
        device."""
        fname = os.path.join(self.directory, f"step_{step:08d}.npz")
        with np.load(fname) as npz:
            flat = {k: npz[k] for k in npz.files}
        pf = {k[len("params/"):]: v for k, v in flat.items()
              if k.startswith("params/")}
        params = _unflatten(params_template, pf, device)
        opt_state = None
        if opt_template is not None:
            of = {k[len("opt_state/"):]: v for k, v in flat.items()
                  if k.startswith("opt_state/")}
            opt_state = _unflatten(opt_template, of, device)
        return params, opt_state

    def restore_latest(self, params_template, opt_template=None,
                       device=None):
        step = self.latest_step()
        if step is None:
            return None, None, None
        p, o = self.restore(step, params_template, opt_template, device)
        return step, p, o
