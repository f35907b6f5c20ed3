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
* :func:`reshard_state` — a model's parameters and AdamW state as this
  rank's blocks on a ``data`` × ``model`` mesh (``distributed/
  sharding.py``'s specs), from global tensors or from blocks on another
  mesh.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.distributed import GridLayout, make_layout
from repro_torch.launch.mesh import Mesh
from repro_torch.models.transformer import MESH_FAMILIES, MESH_NOT_PORTED


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


def reshard_state(params: dict, opt_state: Any, mesh: Mesh, cfg=None, *,
                  from_mesh: Mesh | None = None):
    """Place a model's parameters (name → tensor) and AdamW state (or None)
    as this rank's blocks on ``mesh``: ``(params, opt_state)``, each block
    carrying its spec (``distributed.sharding.spec_of``).

    The inputs are global tensors or, with ``from_mesh``, this rank's
    blocks on that mesh (each carrying its spec), gathered there first
    (collective over it).  The specs are ``sharding.param_specs(params,
    mesh, cfg)``: without ``cfg``, as the reference's ``reshard_state``
    calls it, an MHA model's K/V projections stay replicated over ``model``;
    the trainer passes ``cfg`` (the MHA rule on), as the reference's
    ``build_state`` does.  The step's numbers do not depend on which of the
    two an MHA model got (``distributed.collectives.Parallel.param``).  A
    ``cfg`` of the families whose sharded step is not ported raises
    ``MESH_NOT_PORTED``."""
    from repro_torch.distributed import sharding
    if cfg is not None and (cfg.family not in MESH_FAMILIES or cfg.enc_dec):
        raise NotImplementedError(f"reshard_state: {cfg.name}: {MESH_NOT_PORTED}")

    def whole(tree: dict) -> dict:
        if from_mesh is None:
            return tree
        return {k: sharding.gather_block(v, sharding.spec_of(v), from_mesh).to(v.device)
                for k, v in tree.items()}

    def place(glob: dict) -> dict:
        blocks = sharding.shard_params({k: v.detach() for k, v in glob.items()}, specs, mesh)
        return {k: sharding.set_spec(b, specs[k]) for k, b in blocks.items()}

    glob = whole(params)
    specs = sharding.param_specs(glob, mesh, cfg)
    out = place(glob)
    if opt_state is None:
        return out, None
    return out, type(opt_state)(step=opt_state.step, m=place(whole(opt_state.m)),
                                v=place(whole(opt_state.v)))


def rescale_pipeline(cfg, old_shards: int, new_shards: int, global_batch: int) -> int:
    """New per-shard batch size after a topology change (data re-partition)."""
    assert global_batch % new_shards == 0, (global_batch, new_shards)
    return global_batch // new_shards
