"""The port's training launcher (``launch/train.py``) on the CPU.

* A run that crashes at ``--fail-at`` and is rerun with ``--resume``
  ends on the uninterrupted run's final loss and checkpoint, bit for bit
  (with and without ``--compress``).
* Its presets and flags are the reference's (``build_cfg`` of both
  packages give equal configs), plus ``--device`` (default ``cuda``);
  it prints the reference's lines.
"""
import argparse
import dataclasses
import json

import numpy as np
import pytest

from repro.launch import train as JL
from repro_torch.launch import train as TL


def _args(ckpt, *extra):
    return ["--device", "cpu", "--steps", "8", "--save-every", "2",
            "--log-every", "3", "--ckpt-dir", str(ckpt), *extra]


def _final(ckpt):
    with np.load(ckpt / "step_00000008.npz") as z:
        arrays = {k: z[k].tobytes() for k in z.files}
    with open(ckpt / "MANIFEST.json") as fh:
        return arrays, json.load(fh)


@pytest.mark.parametrize("extra", [[], ["--compress"]],
                         ids=["adamw", "compressed"])
def test_crash_and_resume_equal_an_uninterrupted_run(tmp_path, capsys,
                                                     extra):
    clean = TL.main(_args(tmp_path / "a", *extra))
    with pytest.raises(SystemExit, match="injected failure at step 5"):
        TL.main(_args(tmp_path / "b", "--fail-at", "5", *extra))
    resumed = TL.main(_args(tmp_path / "b", "--resume", *extra))
    assert resumed == clean
    a, b = _final(tmp_path / "a"), _final(tmp_path / "b")
    assert a == b
    assert a[1]["extra"]["loss"] == clean
    out = capsys.readouterr().out
    assert "resumed from step 4 (stateless data pipeline re-seeds at " \
           "step 4)" in out
    assert "config: tinyllama-1.1b-smoke L=2 d=64 vocab=256" in out
    assert "steps=[4, 6, 8]" in out and "final loss" in out


@pytest.mark.parametrize("preset", ["smoke", "100m"])
def test_presets_and_flags_match_reference(preset):
    ns = argparse.Namespace(arch="gemma3-12b", preset=preset,
                            microbatches=3)
    assert dataclasses.asdict(TL.build_cfg(ns)) == \
        dataclasses.asdict(JL.build_cfg(ns))
    assert dataclasses.asdict(TL.PRESET_100M) == \
        dataclasses.asdict(JL.PRESET_100M)
