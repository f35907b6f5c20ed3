"""Seeded fault injection — the chaos harness (counterpart of
``repro/resilience/inject.py``).

A :class:`ChaosPlan` declares *which* faults fire and *where* (all of it
deterministic under ``seed``); a :class:`ChaosInjector` executes the plan
through the ``runtime.monitor.FailureInjector`` hook surface, plus an
operand poisoner applied at submission time.  The serve layer
(``repro_torch.serve.SolverService``) calls the dispatch and build hooks.
Fault classes:

  * **NaN-poisoned operands** — :meth:`ChaosInjector.poison_b` NaNs a
    seeded fraction of submitted right-hand sides.  Downstream, the
    breakdown guards (``repro_torch.core.methods``) must end the loop
    with ``status="breakdown"`` instead of burning ``maxiter`` iterations
    on NaN arithmetic, and a batched solve must end that lane alone.
  * **Collective delay** — ``halo_delay_s`` sleeps on the dispatch path,
    the harness analogue of the paper's §4.2 observation that one noisy
    host inflates every ``MPI_Allreduce``; exercises deadline rejection.
  * **Compile failure** — :meth:`maybe_fail_compile` raises
    :class:`CompileFailure` for matching buckets, every time (a bucket
    that cannot compile stays broken).  The service must convert that
    bucket's queued requests into typed rejects, not strand them.
  * **Preemption / device loss** — :meth:`maybe_fail` raises
    ``SimulatedFailure`` (recoverable: WAL replay) or ``DeviceLost``
    (the service drops its executables and rebuilds them; on a mesh it
    first shrinks the mesh onto the surviving ranks) at planned dispatch
    sequence numbers, once each.  On a mesh every rank runs the same plan,
    so every rank raises at the same dispatch.

The injector is host-side only: faults land between solves, never inside
them, so every test remains deterministic and the executables stay the
ones a clean run builds.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.runtime.monitor import DeviceLost, FailureInjector, SimulatedFailure


class CompileFailure(RuntimeError):
    """An injected (or real) executable-build failure for one bucket."""


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    """What the injector fires, fully determined by the fields + ``seed``.

    ``nan_rate``/``nan_count``: probability a submitted RHS is poisoned
    and how many entries get NaN'd.  ``fail_compile_buckets``: substrings
    matched against the bucket's ``short()`` name; matching compiles
    raise.  ``preempt_at``/``device_loss_at``: dispatch sequence numbers
    (the service's ``seq``) at which to raise, once each.
    ``lose_devices``: the ranks of the service's mesh reported lost with
    ``DeviceLost`` (a rank is one process of the mesh's group, the port's
    device of a mesh; ``runtime.elastic.shrink_mesh`` drops them).
    ``halo_delay_s``: straggler sleep before every dispatch.
    """

    seed: int = 0
    nan_rate: float = 0.0
    nan_count: int = 1
    fail_compile_buckets: tuple[str, ...] = ()
    preempt_at: tuple[int, ...] = ()
    device_loss_at: tuple[int, ...] = ()
    lose_devices: tuple[int, ...] = ()
    halo_delay_s: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.nan_rate <= 1.0:
            raise ValueError(f"nan_rate must be in [0, 1], got {self.nan_rate}")
        if self.nan_count < 1:
            raise ValueError(f"nan_count must be >= 1, got {self.nan_count}")
        if self.halo_delay_s < 0:
            raise ValueError(
                f"halo_delay_s must be >= 0, got {self.halo_delay_s}")


class ChaosInjector(FailureInjector):
    """Executes a :class:`ChaosPlan` through the ``FailureInjector`` hook
    surface."""

    def __init__(self, plan: ChaosPlan):
        super().__init__(fail_at_step=None)
        self.plan = plan
        self._rng = np.random.default_rng(plan.seed)
        self._fired_preempt: set[int] = set()
        self._fired_loss: set[int] = set()
        self.poisoned = 0          # RHSs NaN'd so far (test bookkeeping)
        self.compile_failures = 0

    # -- operand poisoning (applied by the submitter, not the service) --------
    def poison_b(self, b):
        """Maybe NaN-poison one RHS (seeded draw against ``nan_rate``; a
        numpy array or a tensor on any device); returns ``(rhs, poisoned)``
        — the original is never mutated."""
        if self.plan.nan_rate == 0.0 or self._rng.random() >= self.plan.nan_rate:
            return b, False
        size = int(np.prod(b.shape))
        idx = self._rng.integers(0, size, size=self.plan.nan_count)
        if isinstance(b, torch.Tensor):
            out = b.clone()
            out.view(-1)[torch.as_tensor(idx, device=b.device)] = float("nan")
        else:
            out = np.array(b, copy=True)
            out.reshape(-1)[idx] = np.nan
        self.poisoned += 1
        return out, True

    # -- the FailureInjector hook surface -------------------------------------
    def maybe_fail(self, step: int) -> None:
        if self.plan.halo_delay_s:
            # the straggler: one slow host gates the collective (§4.2)
            time.sleep(self.plan.halo_delay_s)
        if step in self.plan.device_loss_at and step not in self._fired_loss:
            self._fired_loss.add(step)
            exc = DeviceLost(
                f"chaos: device(s) {list(self.plan.lose_devices)} lost at "
                f"dispatch {step}")
            exc.lost = tuple(self.plan.lose_devices)
            raise exc
        if step in self.plan.preempt_at and step not in self._fired_preempt:
            self._fired_preempt.add(step)
            self.fired = True
            raise SimulatedFailure(f"chaos: injected preemption at "
                                   f"dispatch {step}")

    def maybe_fail_compile(self, key) -> None:
        name = key.short() if hasattr(key, "short") else str(key)
        if any(pat in name for pat in self.plan.fail_compile_buckets):
            self.compile_failures += 1
            raise CompileFailure(f"chaos: injected compile failure for "
                                 f"bucket {name!r}")
