"""LR schedules: WSD (minicpm's warmup-stable-decay), cosine, constant.

The port's copy of ``repro/optim/schedules.py``.  A schedule maps the step
(an int, or an integer tensor) to the learning rate as an f32 0-d tensor on
the step's device, computed in f32 in the reference's order of operations,
so that each lr is the reference's to the bit: the Python constants enter as
f32 (JAX's weak types), ``max(warmup, 1)`` and the like stay Python ints
until they meet the f32 step.
"""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def wsd(peak_lr: float, warmup: int, stable: int, decay: int,
        final_frac: float = 0.1):
    """MiniCPM's Warmup-Stable-Decay: linear warmup, flat plateau, then a
    linear decay to ``final_frac``·peak."""

    def f(step):
        s = _f32(step)
        warm = peak_lr * s / max(warmup, 1)
        dec_t = (s - warmup - stable) / max(decay, 1)
        dec = peak_lr * (1.0 - (1.0 - final_frac) * torch.clamp(dec_t, 0.0, 1.0))
        plateau = torch.full_like(s, peak_lr)
        return torch.where(s < warmup, warm, torch.where(s < warmup + stable, plateau, dec))

    return f


def cosine(peak_lr: float, warmup: int, total: int, final_frac: float = 0.1):
    def f(step):
        s = _f32(step)
        warm = peak_lr * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(s < warmup, warm, peak_lr * cos)

    return f


def constant(lr: float):
    def f(step):
        return torch.full((), lr, dtype=torch.float32,
                          device=torch.as_tensor(step).device)

    return f


def for_arch(arch_name: str, peak_lr: float = 3e-4, total: int = 10_000):
    """MiniCPM trains with WSD (its headline schedule); others use cosine."""
    if arch_name.startswith("minicpm"):
        return wsd(peak_lr, warmup=total // 100 + 1, stable=int(total * 0.8),
                   decay=int(total * 0.19) + 1)
    return cosine(peak_lr, warmup=total // 100 + 1, total=total)
