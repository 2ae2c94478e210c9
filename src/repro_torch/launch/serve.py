"""Paged-KV model-serving loop: continuous batching of a decoder's KV
store over the slice-pool allocator (the reference's
``launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --requests 4 --max-seqs 2 --max-len 320

Protocol: requests arrive with Zipf-ish prompt/output lengths; a request
is admitted (FIFO) when a sequence slot frees; each decode step reserves
slots via the allocator, layers write staged k/v, and attention runs
through the ``paged_attention`` kernel (its plain version on the CPU).
A freed slot is reused with its old chain kept, as in the reference:
the next request on it continues that slot's length and attends over
its predecessor's tokens too.  At the end it reports throughput plus the
paper's two costs measured on serving: C_M (allocated-vs-used KV waste)
and the mean slice-chain length (pointer hops, C_T).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import analytical
from repro_torch.core.pointers import PoolLayout
from repro_torch.models import transformer as T
from repro_torch.paged import kv_cache as P
from repro_torch.paged import serve_model as SM


def kv_layout(z, max_seqs: int, max_len: int) -> PoolLayout:
    """Pools with enough slices for ``max_seqs`` concurrent ``max_len``
    chains (the reference's sizing)."""
    per_seq = analytical.slices_needed(z, np.asarray([max_len]))[0]
    spp = tuple(max(8, int(max_seqs * per_seq)) for _ in range(len(z)))
    return PoolLayout(z=tuple(z), slices_per_pool=spp)


def serve(cfg, params, layout: PoolLayout, *, requests: int, max_seqs: int,
          max_len: int, seed: int = 0, device="cuda", log=print):
    """Serve ``requests`` requests on ``max_seqs`` slots.  Returns (stats,
    server, final state); ``stats["generated"][r]`` lists request r's
    tokens (the prefill's next token, then one per decode step)."""
    rng = np.random.default_rng(seed)
    server = SM.make_server(cfg, layout, max_seqs, max_len, device)
    state = P.init_kv_state(server.kv_cfg, device)
    dev = server.device

    # request workload
    p_len = np.clip(rng.zipf(1.5, requests) * 4, 4, 64)
    o_len = np.clip(rng.zipf(1.4, requests) * 8, 8, max_len - 80)
    queue = list(range(requests))
    active = {}          # slot -> [remaining_out, last token, request]
    free = list(range(max_seqs))
    generated = {}
    done = 0
    prefill_tokens = decode_tokens = 0
    prefill_s = decode_s = 0.0
    step_ms = []
    log(f"serving {requests} requests on {max_seqs} slots, Z_kv="
        f"{layout.z}; arch={cfg.name} ({cfg.param_count / 1e6:.1f}M)")

    while done < requests:
        # admit
        while queue and free:
            r = queue.pop(0)
            slot = free.pop(0)
            prompt = rng.integers(1, cfg.vocab, size=(1, p_len[r]))
            t0 = time.perf_counter()
            nxt, state = SM.prefill(server, params, state,
                                    np.asarray([slot]),
                                    prompt.astype(np.int32),
                                    np.asarray([p_len[r]]))
            prefill_s += time.perf_counter() - t0
            active[slot] = [int(o_len[r]), int(nxt[0]), r]
            generated[r] = [int(nxt[0])]
            prefill_tokens += int(p_len[r])
        # one decode step for all active sequences
        slots = sorted(active)
        t0 = time.perf_counter()
        ids = torch.as_tensor(slots, dtype=torch.int64, device=dev)
        toks = torch.as_tensor([active[s][1] for s in slots],
                               dtype=torch.int64, device=dev)
        nxt, _, state = SM.decode_step(server, params, state, ids, toks)
        nxt = nxt.cpu().numpy()
        dt = time.perf_counter() - t0
        decode_s += dt
        step_ms.append(dt * 1e3)
        decode_tokens += len(slots)
        for i, s in enumerate(slots):
            active[s][0] -= 1
            active[s][1] = int(nxt[i])
            generated[active[s][2]].append(int(nxt[i]))
            if active[s][0] <= 0:
                done += 1
                free.append(s)     # slots are reused; chains remain
                del active[s]

    lens = state.length.cpu().numpy()
    used = int(lens.sum())
    alloc = P.kv_slots_allocated(server.kv_cfg, state)
    hops = analytical.slices_needed(layout.z, np.maximum(lens[lens > 0], 1))
    total = prefill_tokens + decode_tokens
    seconds = prefill_s + decode_s
    stats = dict(
        requests=requests, tokens=total, prefill_tokens=prefill_tokens,
        decode_tokens=decode_tokens, decode_steps=len(step_ms),
        seconds=seconds, tok_per_s=total / seconds,
        prefill_tok_per_s=prefill_tokens / prefill_s,
        decode_tok_per_s=decode_tokens / decode_s,
        ms_per_step=float(np.mean(step_ms)),
        median_ms_per_step=float(np.median(step_ms)),
        alloc_slots=alloc, used_slots=used,
        cm_waste=(alloc - used) / max(alloc, 1),
        mean_hops=float(hops.mean()),
        outgrew_max_len=int((lens > max_len).sum()),
        overflow=bool(state.overflow), lengths=lens.tolist(),
        watermark=state.watermark.cpu().numpy().tolist(),
        generated=generated)
    log(f"done: {requests} requests, {total} tokens in {seconds:.1f}s "
        f"({stats['tok_per_s']:.1f} tok/s on {dev.type})")
    log(f"paper-costs on serving: C_M waste = {stats['cm_waste'] * 100:.1f}% "
        f"(alloc {alloc} vs used {used} slots); mean slice-chain hops = "
        f"{stats['mean_hops']:.2f}")
    return stats, server, state


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="paged-KV model-serving loop (decoder KV cache on the "
                    "slice-pool allocator)")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-seqs", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=448)
    ap.add_argument("--z", default="6,8,10",
                    help="KV slice config Z_kv (log2 tokens per slice)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    z = tuple(int(v) for v in args.z.split(","))
    cfg = registry.reduced_config(args.arch)
    params = T.init_lm(cfg, seed=1, device=args.device)
    layout = kv_layout(z, args.max_seqs, args.max_len)
    stats, _, _ = serve(cfg, params, layout, requests=args.requests,
                        max_seqs=args.max_seqs, max_len=args.max_len,
                        seed=args.seed, device=args.device)
    return stats["tok_per_s"]


if __name__ == "__main__":
    main()
