"""Shared wall-clock helper (counterpart of ``repro/api/timing.py``).

PyTorch returns before the card finishes, so every timed call ends in
``torch.cuda.synchronize()`` (where the reference used ``block_until_ready``);
warm-up calls run outside the timed region.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn: Callable, *args, repeats: int = 10,
          warmup: int = 1) -> dict[str, float]:
    """Median/quartile seconds of ``repeats`` fully synchronised calls."""
    _, stats = timed_result(fn, *args, repeats=repeats, warmup=warmup)
    return stats


def timed_result(fn: Callable, *args, repeats: int = 10,
                 warmup: int = 1) -> tuple[Any, dict[str, float]]:
    """Like :func:`timed` but also returns the (last) result of ``fn``."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
        _sync()
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync()
        ts.append(time.perf_counter() - t0)
    ts = np.array(ts)
    return out, {
        "median": float(np.median(ts)),
        "q1": float(np.quantile(ts, 0.25)),
        "q3": float(np.quantile(ts, 0.75)),
        "min": float(ts.min()),
        "mean": float(ts.mean()),
    }
