"""Straggler detection and failure handling around a train step (the
reference's ``train/elastic.py``):

  * :class:`StepTimer` — EMA step-time tracker; flags stragglers
    (step > factor x EMA) and keeps a health report.
  * :class:`TrainLoopRunner` — a checkpoint/resume train loop with
    injected failure: ``run`` raises at ``fail_at``, ``resume`` restores
    the latest checkpoint, and the resumed run ends on the same
    parameters as an uninterrupted one (the fault-tolerance contract).

Checkpoints are host arrays (``checkpoint.py``), so a restore may put the
state on any device.  The step function is timed on the host clock; on
the card it returns before the device finishes unless it synchronises,
so ``StepTimer`` reads what the caller's step waits for.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

from repro_torch.train.checkpoint import CheckpointManager


@dataclasses.dataclass
class StepTimer:
    alpha: float = 0.1
    straggler_factor: float = 3.0
    ema: Optional[float] = None
    stragglers: List[int] = dataclasses.field(default_factory=list)
    _t0: Optional[float] = None
    step: int = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> bool:
        """Returns True if this step was a straggler."""
        dt = time.perf_counter() - self._t0
        return self.observe(dt)

    def observe(self, dt: float) -> bool:
        self.step += 1
        is_straggler = (self.ema is not None
                        and dt > self.straggler_factor * self.ema)
        if is_straggler:
            self.stragglers.append(self.step)
            # do not fold outliers into the EMA (keeps threshold stable)
            return True
        self.ema = dt if self.ema is None else (
            (1 - self.alpha) * self.ema + self.alpha * dt)
        return False

    def report(self) -> dict:
        return {"steps": self.step, "ema_s": self.ema,
                "n_stragglers": len(self.stragglers),
                "straggler_steps": list(self.stragglers)}


class TrainLoopRunner:
    """Checkpoint/restart harness around a train step
    ``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)``."""

    def __init__(self, step_fn: Callable, ckpt: CheckpointManager,
                 save_every: int = 10):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.save_every = save_every
        self.timer = StepTimer()

    def run(self, params, opt_state, batches, start_step: int = 0,
            fail_at: Optional[int] = None):
        """Run until batches are exhausted; raise at ``fail_at`` to
        simulate a node failure (after any due checkpoint)."""
        step = start_step
        for batch in batches:
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"injected failure at step {step}")
            self.timer.start()
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            self.timer.stop()
            step += 1
            if step % self.save_every == 0:
                self.ckpt.save(step, params, opt_state,
                               extra={"metrics": {
                                   k: float(v) for k, v in metrics.items()}})
        return step, params, opt_state

    def resume(self, params_template, opt_template):
        out = self.ckpt.restore_latest(params_template, opt_template)
        if out[0] is None:
            return 0, params_template, opt_template
        return out
