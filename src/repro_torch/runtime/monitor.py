"""Failure injection (the port's copy of three classes of
``repro/runtime/monitor.py``).

``FailureInjector`` is the duck-typed hook surface the chaos harness
(``repro_torch.resilience.inject.ChaosInjector``) extends:
``maybe_fail(step)`` at dispatch points and ``maybe_fail_compile(key)`` at
build points.  The reference's ``Heartbeat`` and ``scan_hosts`` come with
the serve port (ROADMAP queue 1 item 11).
"""

from __future__ import annotations


class FailureInjector:
    """Raises ``SimulatedFailure`` at the configured step (tests/examples).

    ``maybe_fail(step)`` is the dispatch hook and ``maybe_fail_compile(key)``
    the build hook; the base injector never fails a build."""

    def __init__(self, fail_at_step: int | None):
        self.fail_at_step = fail_at_step
        self.fired = False

    def maybe_fail(self, step: int) -> None:
        if (self.fail_at_step is not None and step == self.fail_at_step
                and not self.fired):
            self.fired = True
            raise SimulatedFailure(f"injected failure at step {step}")

    def maybe_fail_compile(self, key) -> None:
        """Hook point before a build keyed by ``key`` (a solve shape, ...).
        No-op here; chaos injectors override it."""


class SimulatedFailure(RuntimeError):
    pass


class DeviceLost(RuntimeError):
    """A device dropped out mid-run (the chaos harness raises it
    deterministically)."""
