"""Deterministic sharded token pipeline with host prefetch (the port's copy of
``repro/data/pipeline.py``: the same numpy ``RandomState`` seeds, so batch
``t`` of shard ``s`` is the reference's array for array).  The batches are
numpy arrays on the host; the trainer moves them to the device.

Two sources:
  * ``SyntheticSource`` — seeded zipf-ish token stream (self-contained runs),
  * ``MemmapSource``    — flat binary token file (uint16/uint32), the
    standard "tokenized corpus on disk" format.

Determinism contract (needed for fault-tolerant resume): batch ``t`` for data
shard ``s`` depends only on ``(seed, t, s)`` — restarting from a checkpoint
at step ``t`` reproduces the exact stream, and *elastic* restarts (different
shard count) only re-partition future batches.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


class SyntheticSource:
    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab_size = vocab_size
        self.seed = seed

    def tokens(self, step: int, shard: int, n: int) -> np.ndarray:
        rs = np.random.RandomState(
            (self.seed * 1_000_003 + step * 997 + shard) % (2 ** 31))
        # zipf-ish distribution clipped to vocab
        z = rs.zipf(1.3, size=n).astype(np.int64)
        return (z % self.vocab_size).astype(np.int32)


class MemmapSource:
    def __init__(self, path: str, vocab_size: int, dtype=np.uint16):
        self.arr = np.memmap(path, dtype=dtype, mode="r")
        self.vocab_size = vocab_size

    def tokens(self, step: int, shard: int, n: int) -> np.ndarray:
        total = self.arr.shape[0]
        start = (step * 31_337 + shard * 7_919) * n % max(total - n, 1)
        return np.asarray(self.arr[start: start + n], dtype=np.int32) % self.vocab_size


@dataclass
class PipelineConfig:
    batch_size: int            # per-shard batch
    seq_len: int
    n_shards: int = 1
    shard: int = 0
    seed: int = 0
    mrope: bool = False
    frontend: str = "none"     # none | vision | audio
    d_model: int = 0
    enc_dec: bool = False
    src_fraction: int = 4


def make_batch(source, cfg: PipelineConfig, step: int) -> dict:
    B, S = cfg.batch_size, cfg.seq_len
    toks = source.tokens(step, cfg.shard, B * (S + 1)).reshape(B, S + 1)
    batch = {
        "tokens": toks[:, :-1].copy(),
        "targets": toks[:, 1:].copy(),
    }
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    if cfg.mrope:
        batch["positions"] = np.broadcast_to(pos, (3, B, S)).copy()
    else:
        batch["positions"] = pos.copy()
    if cfg.frontend != "none":
        rs = np.random.RandomState((cfg.seed + step) % (2 ** 31))
        batch["embeds"] = (rs.randn(B, S, cfg.d_model) * 0.02).astype(np.float32)
        batch.pop("tokens")
    if cfg.enc_dec:
        T = S // cfg.src_fraction
        rs = np.random.RandomState((cfg.seed + step + 1) % (2 ** 31))
        batch["src_embeds"] = (rs.randn(B, T, cfg.d_model) * 0.02).astype(np.float32)
        batch["src_positions"] = np.broadcast_to(
            np.arange(T, dtype=np.int32), (B, T)).copy()
        batch["tokens"] = batch.get("tokens", toks[:, :-1].copy())
        batch.pop("embeds", None)
    return batch


def batches(source, cfg: PipelineConfig, start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield make_batch(source, cfg, step)
        step += 1


class Prefetcher:
    """Background-thread prefetch of host batches (depth-bounded)."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def run():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)

        self.t = threading.Thread(target=run, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        """Stop the thread: it ends at its next item, once the drained queue
        has taken the one it may be waiting to put; joined within 30 s."""
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.t.join(30.0)
