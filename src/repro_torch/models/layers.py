"""Shared layers of the decoder: RMSNorm, RoPE, SwiGLU and the dense
initialiser, over plain tensors (the reference's ``models/layers.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm with a ``(1 + weight)`` scale, in fp32, cast back."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(dtype)


def rope(x, positions, theta: float = 10_000.0):
    """Rotary embedding with fp32 angles. x: [..., S, H, D]; positions:
    [..., S]."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., :, None].float() * freq   # [..., S, half]
    cos = torch.cos(angles)[..., :, None, :]          # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.split(x.float(), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def make_generator(device, seed: int) -> torch.Generator:
    """A seeded generator for draws on ``device``.  The ``meta`` device
    has no generator of its own; a CPU one stands in (a draw on ``meta``
    makes a shape and consumes nothing)."""
    dev = torch.device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    return gen


def draw_device(generator: torch.Generator, device=None) -> torch.device:
    """Where an init draws: ``device`` when given, else the generator's."""
    return generator.device if device is None else torch.device(device)


def dense_init(generator: torch.Generator, shape, dtype,
               scale: Optional[float] = None, device=None):
    """Normal(0, 1) * scale (default ``fan_in ** -0.5``, fan_in =
    ``shape[-2]``), drawn in fp32 on ``device`` (by default the
    generator's)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=draw_device(generator, device))
    return (w * scale).to(dtype)
