"""End-to-end LM training launcher (the reference's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch tinyllama-1.1b --steps 20

Features exercised: AdamW (+optional int8 gradient compression with error
feedback), microbatch gradient accumulation, checkpoint/keep-k/manifest,
crash injection (``--fail-at``) and exact restart (``--resume``),
straggler watchdog (StepTimer EMA).  The flags, presets and printed lines
are the reference's; ``--device`` (default ``cuda``) picks the device.
On the card a run is in ``torch.use_deterministic_algorithms`` mode,
with cuBLAS's fixed workspace (``CUBLAS_WORKSPACE_CONFIG=:4096:8`` unless
the environment sets it), because exact restart needs it there: the
token embedding's gradient and the loss's gather backward are
accumulating scatters.  Batches are a pure function of the step
(``data/lm_data.py``), so a resumed run sees the batches the crashed one
would have.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import LMConfig
from repro_torch.data import lm_data
from repro_torch.models import transformer as T
from repro_torch.train import steps as S
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.compression import CompressedAdamW
from repro_torch.train.elastic import StepTimer
from repro_torch.train.optimizer import AdamW

PRESET_100M = LMConfig(
    name="lm-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
    d_ff=2048, vocab=32000, remat=False)


def build_cfg(args) -> LMConfig:
    if args.preset == "100m":
        cfg = PRESET_100M
    else:
        cfg = registry.reduced_config(args.arch)
    return dataclasses.replace(cfg, n_microbatches=args.microbatches)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "100m"])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--compress", action="store_true",
                    help="int8 gradient compression w/ error feedback")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a crash at this step (fault-tolerance demo)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type != "cuda":
        return train(args)
    # before cuBLAS's first call, which reads the workspace setting
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return train(args)
    finally:
        torch.use_deterministic_algorithms(was)


def train(args):
    cfg = build_cfg(args)
    print(f"config: {cfg.name} L={cfg.n_layers} d={cfg.d_model} "
          f"vocab={cfg.vocab} params={cfg.param_count / 1e6:.1f}M "
          f"moe={cfg.moe}")

    opt = AdamW(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    opt_like = CompressedAdamW(opt) if args.compress else opt

    params = T.init_lm(cfg, seed=0, device=args.device)
    opt_state = opt_like.init(params)

    def loss_fn(p, tokens):
        return T.lm_loss(p, tokens, cfg, q_chunk=64)

    def train_step(p, st, tokens):
        loss, grads = S._accumulate_grads(loss_fn, p, tokens,
                                          cfg.n_microbatches)
        p, st = opt_like.update(grads, st, p)
        return p, st, loss

    data_cfg = lm_data.LMDataConfig(vocab=cfg.vocab, batch=args.batch,
                                    seq_len=args.seq)
    batch_at = lm_data.make_batch_fn(data_cfg, device=args.device)

    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    start = 0
    if args.resume:
        restored = ckpt.restore_latest(params, opt_state)
        if restored[0] is not None:
            start, params, opt_state = restored
            print(f"resumed from step {start} "
                  f"(stateless data pipeline re-seeds at step {start})")

    timer = StepTimer()
    t0 = time.time()
    for step in range(start, args.steps):
        if args.fail_at is not None and step == args.fail_at:
            raise SystemExit(f"injected failure at step {step} — rerun "
                             f"with --resume")
        timer.start()
        params, opt_state, loss = train_step(params, opt_state,
                                             batch_at(step))
        loss_f = float(loss)          # waits for the step's device work
        straggler = timer.stop()
        if straggler:
            print(f"[watchdog] step {step} is a straggler: "
                  f"{timer.report()}")
        if (step + 1) % args.save_every == 0:
            ckpt.save(step + 1, params, opt_state, extra={"loss": loss_f})
        if step % args.log_every == 0 or step == args.steps - 1:
            ema = timer.report()["ema_s"] or 1e-9
            tps = args.batch * args.seq / ema
            print(f"step {step:4d} loss {loss_f:8.4f} "
                  f"tok/s {tps:9.0f}")
    dt = time.time() - t0
    print(f"done: {args.steps - start} steps in {dt:.1f}s; "
          f"final loss {float(loss):.4f}; checkpoints at {args.ckpt_dir} "
          f"steps={ckpt.all_steps()}")
    return float(loss)


if __name__ == "__main__":
    main()
