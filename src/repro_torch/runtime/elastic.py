"""Elastic rescaling: move work between mesh topologies (counterpart of
``repro/runtime/elastic.py``).

Checkpoints and the serve layer's write-ahead journal hold global host
arrays (``runtime/checkpoint.py``), so moving from P ranks to P′ is: restore,
then place each array as the new mesh's block of it.  A rank here is one
process of a ``torch.distributed`` group (``launch/mesh.py``), so a mesh
that loses ranks is rebuilt on a subgroup of the survivors, and the ranks
left out of it get no mesh: they stop.

* :func:`shrink_mesh` — the 1-axis mesh over the surviving ranks, trimmed to
  a count that divides the decomposed grid extent;
* :func:`reshard_array` — a global host array as this rank's block on the
  device;
* :func:`rescale_pipeline` — the per-shard batch after a topology change;
* :func:`reshard_state` — a model's parameters and optimizer state onto a
  mesh: it needs ``distributed/sharding.py`` on gloo ranks, the next slice
  of the training half (ROADMAP queue 1 item 14d); until then it raises
  :data:`MESH_NOT_PORTED`, as ``launch/train.py`` does on a mesh.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.distributed import GridLayout, make_layout
from repro_torch.launch.mesh import Mesh


def survivors(mesh: Mesh, lost: Sequence[int] = (), *,
              divides: int | None = None) -> list[int]:
    """The mesh ranks :func:`shrink_mesh` keeps: every rank not in
    ``lost``, the first ``n`` of them, ``n`` the largest count that divides
    ``divides`` (all of them without it)."""
    lost_ids = set(lost)
    keep = [r for r in range(mesh.size) if r not in lost_ids]
    if not keep:
        raise ValueError(f"no ranks survive losing {sorted(lost_ids)}")
    if divides is not None:
        n = len(keep)
        while n > 1 and divides % n:
            n -= 1
        keep = keep[:n]
    return keep


def shrink_mesh(mesh: Mesh, lost: Sequence[int] = (), *,
                divides: int | None = None) -> Mesh | None:
    """The same-named 1-axis mesh over the ranks surviving a loss (the
    serve layer's device-loss resume): drop the ``lost`` mesh ranks,
    optionally trim to the largest count that divides ``divides`` (the
    decomposed grid extent: the blocks must split it evenly), and rebuild
    the mesh on a ``dist.new_group`` of the survivors.  Every rank of the
    old mesh calls it; a rank left out of the new mesh gets ``None``.
    Multi-axis meshes raise: shrinking a pod×data×model mesh is a layout
    decision, not a mechanical one — rebuild it explicitly."""
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"shrink_mesh handles 1-axis meshes (the paper's 1-D z "
            f"decomposition); got axes {mesh.axis_names} — rebuild the "
            f"topology explicitly")
    keep = survivors(mesh, lost, divides=divides)
    if mesh.backend is None:                 # one rank, no group: it survives
        return Mesh.one_rank(mesh.axis_names)
    ranks = [r if mesh.group is None else dist.get_global_rank(mesh.group, r)
             for r in keep]
    # a group-local barrier: the members meet, the others return at once
    group = dist.new_group(ranks, use_local_synchronization=True)
    if mesh.rank not in keep:
        return None
    return Mesh((len(keep),), mesh.axis_names, group=group)


def reshard_array(x: Any, mesh: Mesh, layout: GridLayout | None = None, *,
                  device=None, dtype: torch.dtype | None = None) -> torch.Tensor:
    """This rank's block of ``x`` on ``device`` (the default: the CPU).

    The elastic restore of the serve recovery path: a preempted batch's
    journal entry is global host arrays, so the service that recovers it
    may run another topology than the one that was preempted, and restore
    is placement onto the current mesh.  ``x`` is a global array (numpy or
    a tensor) whose last three axes are the grid; leading axes (lanes)
    pass through.  ``layout`` defaults to the mesh's
    (``core.distributed.make_layout``)."""
    layout = make_layout(mesh) if layout is None else layout
    if layout.mesh is not mesh:
        raise ValueError("the layout is not on this mesh")
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    block = layout.block(t, tuple(t.shape[-3:]))
    return block.to(device=device or "cpu", dtype=dtype or block.dtype)


#: the refusal of a mesh, here and in ``launch/train.py``
MESH_NOT_PORTED = (
    "training on more than one rank needs distributed/sharding.py on gloo ranks and "
    "runtime/elastic.py::reshard_state, the next slice of the training half "
    "(ROADMAP.md queue 1 item 14d); launch/train.py runs on one device")


def reshard_state(params: Any, opt_state: Any, mesh: Mesh):
    """Place a model's parameters and optimizer state onto ``mesh``: not
    ported yet, it needs the parameters' and AdamW state's sharding rules
    (``distributed/sharding.py`` on gloo ranks), the next slice of the
    training half."""
    raise NotImplementedError(f"reshard_state: {MESH_NOT_PORTED}")


def rescale_pipeline(cfg, old_shards: int, new_shards: int, global_batch: int) -> int:
    """New per-shard batch size after a topology change (data re-partition)."""
    assert global_batch % new_shards == 0, (global_batch, new_shards)
    return global_batch // new_shards
