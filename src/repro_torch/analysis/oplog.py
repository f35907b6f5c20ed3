"""The op log of a solver step: the port's counterpart of
``repro/analysis/hlo.py``.

The reference reads its program from the compiled HLO and measures, for each
collective, the work the dependence graph lets run beside it.  The port has
no HLO: its program is the ordered sequence of operations one step issues on
a rank.  :class:`OpLog` records that sequence:

* every aten op, with the bytes it reads and writes (each tensor operand
  read once, each output that is not an operand written once; views and
  bare allocations move nothing), through a ``TorchDispatchMode``;
* every launch of a hand-written kernel, with the bytes its bound is
  computed from (each operand read once, each output written once): a
  dispatch mode does not see a kernel's own launch, so the kernel wrappers
  report it where they count it (``kernels.ops.OBSERVER``);
* interleaved, the recording comm's starts and waits
  (``Mesh.record(events=log.events)``), each start with its payload bytes.

A collective's *slack* is the bytes of work issued between its start and
its wait: in eager PyTorch a started collective is in flight exactly while
that work is issued.  ``count_collectives``, ``collective_stats``,
``collective_bytes`` and ``overlap_slack`` keep the reference's names.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: aten ops that allocate without writing (their output is not work)
_ALLOCATIONS = frozenset({
    "aten.empty.memory_format", "aten.empty_like.default", "aten.new_empty.default",
    "aten.empty_strided.default", "aten.new_empty_strided.default",
})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes an aten op moves: each tensor operand read once and each
    output that is not an operand written once; 0 for a view or a bare
    allocation."""
    if func.is_view or str(func) in _ALLOCATIONS:
        return 0
    ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
    outs = [t for t in tree_leaves(out)
            if isinstance(t, torch.Tensor) and not any(t is i for i in ins)]
    return sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)


class OpLog(TorchDispatchMode):
    """Records the operations issued inside ``with OpLog() as log:`` into
    ``log.events`` (dicts with ``event`` ``"op"``, ``op`` and ``bytes``);
    a kernel launch is logged as ``op`` ``"kernel:<name>"``.  Pass
    ``log.events`` to ``Mesh.record`` to interleave the comm's starts and
    waits.  Ops outside the ``aten`` namespace (the collectives' own
    dispatcher ops) are not work and are not logged."""

    def __init__(self):
        super().__init__()
        self.events: list[dict] = []
        self._observer = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "aten":
            self.events.append({"event": "op", "op": str(func),
                                "bytes": op_bytes(func, args, kwargs, out)})
        return out

    def _kernel(self, name: str, nbytes: int) -> None:
        self.events.append({"event": "op", "op": f"kernel:{name}", "bytes": nbytes})

    def __enter__(self):
        from repro_torch.kernels import ops
        self._observer, ops.OBSERVER = ops.OBSERVER, self._kernel
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.OBSERVER = self._observer
        return super().__exit__(*exc)


def _starts(events: list[dict]):
    return [e for e in events if e["event"] == "start"]


def count_collectives(events: list[dict]) -> dict[str, int]:
    """Collectives started in the log, by name."""
    counts: dict[str, int] = {}
    for e in _starts(events):
        counts[e["op"]] = counts.get(e["op"], 0) + 1
    return counts


def collective_stats(events: list[dict]) -> dict[str, dict[str, int]]:
    """Per collective ``{"count": n, "bytes": b}``, ``b`` the payload this
    rank sent: counts catch structural drift, bytes payload drift."""
    stats: dict[str, dict[str, int]] = {}
    for e in _starts(events):
        rec = stats.setdefault(e["op"], {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += e["bytes"]
    return stats


def collective_bytes(events: list[dict]) -> int:
    """The payload bytes of every collective in the log."""
    return sum(e["bytes"] for e in _starts(events))


def work_bytes(events: list[dict]) -> int:
    """The bytes of work (ops and kernel launches) in the log."""
    return sum(e["bytes"] for e in events if e["event"] == "op")


def overlap_slack(events: list[dict], ops: tuple[str, ...] | None = None) -> list[dict]:
    """For each collective (restricted to the names in ``ops``), in issue
    order: the bytes of work issued between its start and its wait
    (``slack_bytes``, to the end of the log if it was never waited:
    ``waited`` False) and their share of the log's work
    (``slack_fraction``), with its payload ``bytes`` and, for a halo swap,
    the bytes of one boundary ``plane``."""
    total = work_bytes(events) or 1
    out, open_ = [], {}
    for e in events:
        if e["event"] == "start":
            if ops is None or e["op"] in ops:
                rec = dict(op=e["op"], id=e["id"], bytes=e["bytes"], plane=e["plane"],
                           slack_bytes=0, waited=False)
                out.append(rec)
                open_[e["id"]] = rec
        elif e["event"] == "wait":
            rec = open_.pop(e["id"], None)
            if rec is not None:
                rec["waited"] = True
        else:
            for rec in open_.values():
                rec["slack_bytes"] += e["bytes"]
    for rec in out:
        rec["slack_fraction"] = rec["slack_bytes"] / total
    return out
