"""LRU cache of pre-built solver executables, one entry per bucket (the port's
copy of ``repro/serve/cache.py``).

An entry owns a ``SolverSession`` whose batched executable was built at the
service's fixed padded batch size (``session.compile_batched``: its static
buffers and, on the card, its CUDA graphs), so every dispatch is a warm
call.  The cache is bounded: inserting past ``capacity`` evicts the
least-recently-*dispatched* bucket, dropping its session (and with it the
executable).

Counter semantics (exported through ``stats()``):

  * ``miss``  — a bucket needed an executable that wasn't resident; each
    miss is exactly one build (the service's compile-then-admit path).
  * ``hit``   — one dispatched batch served from a resident entry.
  * ``eviction`` — one entry dropped to respect ``capacity``.

Per-bucket build seconds come from the session's own ``cache_stats()``.
"""

from __future__ import annotations

from collections import OrderedDict

from repro_torch.api import SolverOptions, SolverSession
from repro_torch.serve.queue import BucketKey


def session_for(key: BucketKey, *, kernels: bool = False, guards: bool = False,
                device="cuda", mesh=None) -> SolverSession:
    """Build the ``SolverSession`` a bucket's executable lives in.

    ``kernels`` is the reference's ``pallas``.  ``guards`` arms the
    breakdown guards so every batched dispatch returns each lane's own
    ``status`` for the poison quarantine; the recovery policy stays
    ``"none"`` — the service, not the session, decides what a poisoned lane
    costs (a batch is never re-solved for one bad lane).  ``mesh`` (a
    ``launch.mesh.Mesh``) pins the bucket to it: the session solves this
    rank's blocks of the global grid, and building it is a collective (the
    tune decision is broadcast), so every rank of the mesh builds it."""
    tol, maxiter, norm_ref, pp = key.solve_params
    opts = SolverOptions(tol=tol, maxiter=maxiter, norm_ref=norm_ref,
                         f64=(key.dtype == "f64"), kernels=kernels,
                         precond=key.precond,
                         precond_params=dict(pp) if pp else None,
                         guards=guards,
                         on_breakdown="none" if guards else "raise")
    return SolverSession(method=key.method, grid=key.grid, stencil=key.stencil,
                         options=opts, device=device, mesh=mesh)


class CacheEntry:
    """One resident bucket: its session + the padded batch size it was
    built at."""

    def __init__(self, key: BucketKey, session: SolverSession, batch: int):
        self.key = key
        self.session = session
        self.batch = batch
        self.batches_served = 0

    def compile_seconds(self) -> float:
        return sum(st["compile_s"]
                   for st in self.session.cache_stats().values())


class ExecutableCache:
    """Bounded LRU of ``CacheEntry``, with hit/miss/eviction counters."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: OrderedDict[BucketKey, CacheEntry] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._per_key: dict[BucketKey, dict] = {}

    def _counters(self, key: BucketKey) -> dict:
        return self._per_key.setdefault(
            key, {"hits": 0, "misses": 0, "evictions": 0, "compile_s": 0.0})

    def contains(self, key: BucketKey) -> bool:
        """Residency check WITHOUT touching LRU order or counters (the
        scheduler peeks constantly; only dispatches should count)."""
        return key in self._entries

    def lookup(self, key: BucketKey) -> CacheEntry | None:
        """Dispatch-path lookup: counts a hit and refreshes LRU order."""
        ent = self._entries.get(key)
        if ent is None:
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        self._counters(key)["hits"] += 1
        ent.batches_served += 1
        return ent

    def record_miss(self, key: BucketKey) -> None:
        """A bucket needed a non-resident executable; the service pairs
        every miss with exactly one compile-then-admit."""
        self.misses += 1
        self._counters(key)["misses"] += 1

    def insert(self, entry: CacheEntry) -> list[BucketKey]:
        """Admit a built entry; returns the evicted keys (if any)."""
        self._entries[entry.key] = entry
        self._entries.move_to_end(entry.key)
        self._counters(entry.key)["compile_s"] += entry.compile_seconds()
        evicted = []
        while len(self._entries) > self.capacity:
            k, dropped = self._entries.popitem(last=False)
            del dropped
            self.evictions += 1
            self._counters(k)["evictions"] += 1
            evicted.append(k)
        return evicted

    def clear(self) -> list[BucketKey]:
        """Drop every resident entry WITHOUT counting evictions — the
        device-loss path: dropping them is a correctness act, not an LRU
        capacity decision.  Counters survive (the rebuilds that follow are
        honest misses).  Returns the dropped keys."""
        keys = list(self._entries)
        self._entries.clear()
        return keys

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "entries": len(self._entries),
            "capacity": self.capacity,
            "per_bucket": {k.short(): dict(v)
                           for k, v in self._per_key.items()},
        }
