"""Device timers for the port's kernels: CUDA events and the profiler.

``chip_smoke.py``, ``launch/time_paged_attention.py``,
``launch/time_intersect_mask.py`` and ``launch/time_embedding_bag.py``
time every kernel with these, so two checkouts timed in one call share
one yardstick.  This module imports nothing but torch: the A/B scripts
load it by path beside another checkout's ``repro_torch``.

The event timers first put the device to sleep while the host queues the
timed launches (the head start), so a call shorter than its host-side
cost is timed on the device, not at the host's launch rate.  The sleep
is sized from the host's time per call in the warm-up, so it outlasts the
queueing of every timed repeat.
"""
from __future__ import annotations

import time

import torch

SLEEP_CYCLES_PER_S = 2.0e9     # at or above the H100's 1.98 GHz boost clock
MIN_HEAD_START_S = 0.0025
MAX_HEAD_START_S = 0.25


def _head_start(host_s_per_rep: float, reps: int) -> None:
    """Sleep the device for twice the host's time to queue ``reps``
    repeats (at least ``MIN_HEAD_START_S``, at most
    ``MAX_HEAD_START_S``)."""
    s = min(max(2.0 * reps * host_s_per_rep, MIN_HEAD_START_S),
            MAX_HEAD_START_S)
    torch.cuda._sleep(int(s * SLEEP_CYCLES_PER_S))


def _warm(fn, warmup: int, before=None) -> float:
    """Run ``warmup`` calls; return the host's seconds per call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        if before is not None:
            before()
        fn()
    return (time.perf_counter() - t0) / max(warmup, 1)


def cuda_ms(fn, reps: int = 10, warmup: int = 2,
            head_start: bool = True) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back launches,
    CUDA events around them all.  ``head_start=False`` drops the device
    sleep, to compare with times taken without one (a short call is
    then timed at the host's launch rate)."""
    host = _warm(fn, warmup)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if head_start:
        _head_start(host, reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, flush, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches, each timed by
    its own CUDA events after ``flush`` (a buffer larger than the 50 MB
    L2) is overwritten, so the call finds its operands cold as a serving
    call does."""
    host = _warm(fn, warmup, before=flush.zero_)
    spans = []
    torch.cuda.synchronize()
    _head_start(host, reps)
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        spans.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in spans) / reps


def profiled_ms(fn, match: str, reps: int = 10, warmup: int = 2,
                sessions: int = 3):
    """Mean device duration of the kernels whose name holds ``match``,
    one per call of ``fn``, from the profiler's own kernel records (no
    host clock, no events between launches): ``(ms, n)`` over the last
    ``reps`` such kernels, or ``(None, n)`` when the profiler recorded
    fewer than ``reps`` of them in each of ``sessions`` tries.  A
    session opens with 64 one-element fills and one call, which absorb
    the device events a session late in a process may drop (21 seen, and
    once every event of a short session)."""
    from torch.profiler import ProfilerActivity, profile
    _warm(fn, warmup)
    pad = torch.empty(1, device="cuda")
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(64):
                pad.zero_()
            fn()
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ks = sorted((e.time_range.start, e.device_time_total)
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and match in e.name)
        if len(ks) >= reps:
            return sum(t for _, t in ks[-reps:]) / reps / 1e3, len(ks)
    return None, len(ks)


def profiled_total_ms(fn, match: str, reps: int = 1, warmup: int = 1):
    """Summed device duration, per call of ``fn``, of the kernels whose
    name holds ``match`` (a call may launch many), from the profiler's
    kernel records over ``reps`` calls in one session, after 64
    one-element fills that absorb events a session may drop: ``(ms, n)``
    with ``n`` the kernels seen in all, for the caller to check."""
    from torch.profiler import ProfilerActivity, profile
    _warm(fn, warmup)
    pad = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            pad.zero_()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ks = [e.device_time_total for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and match in e.name]
    return sum(ks) / reps / 1e3, len(ks)


def kernel_name(name: str) -> str:
    """A device kernel's short name: the identifier before its template
    arguments or parameters (``bag_bwd_rows``,
    ``DeviceRadixSortOnesweepKernel``, ``vectorized_elementwise_kernel``)."""
    head = name.replace("(anonymous namespace)::", "")
    head = head[5:] if head.startswith("void ") else head
    return head.split("(")[0].split("<")[0].split("::")[-1].strip() or name


def profiled_parts(fn, reps: int = 5, warmup: int = 2):
    """Each device kernel's summed duration per call of ``fn``, by short
    name (:func:`kernel_name`), from the profiler's kernel records of
    ``reps`` calls in one session after 64 one-element fills and one
    call, which absorb events a session may drop: ``({name: ms}, busy
    ms)``, both per call."""
    from torch.profiler import ProfilerActivity, profile, record_function
    _warm(fn, warmup)
    pad = torch.empty(1, device="cuda")
    mark = "timing.profiled_parts"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            pad.zero_()
        fn()
        torch.cuda.synchronize()
        with record_function(mark):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    events = prof.events()
    start = min(e.time_range.start for e in events if e.name == mark)
    parts = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                e.name != mark and e.time_range.start >= start:
            k = kernel_name(e.name)
            parts[k] = parts.get(k, 0.0) + e.device_time_total / 1e3 / reps
    return parts, sum(parts.values())
