"""Checkpointing: atomic writes, retention, background writes (the port's copy
of ``repro/runtime/checkpoint.py``).

A checkpoint is one ``.npy`` per leaf plus a ``manifest.json`` under
``directory/step_<n>``, written to ``step_<n>.tmp`` and renamed into place,
so a reader never sees half a step; ``keep`` bounds how many steps stay.
The leaves are those of a tree of dicts (keys sorted), lists and tuples
whose leaves are numpy arrays, tensors (any device) or scalars; a leaf's
file is its path of keys and indices joined by ``__``, the names the
reference's ``tree_flatten_with_path`` gives, so a directory written by
either package restores in the other (the serve layer's write-ahead journal
is the case that matters).

A bf16 tensor is stored as its ``uint16`` view (as the reference stores
``ml_dtypes.bfloat16``) and read back into the template's dtype.  A tensor
template leaf restores to a tensor on the template's device, a numpy one to
numpy.  ``restore(..., shardings=...)`` places leaves onto a mesh, as the
reference's does: ``shardings`` is a prefix tree of the template whose
leaves are placements ``(mesh, layout)`` (a ``launch.mesh.Mesh`` and a
``core.distributed.GridLayout`` on it, or ``None`` for the mesh's default
layout) or ``None`` (no placement); each placed leaf is read as the global
host array it was saved as and becomes this rank's block
(``runtime.elastic.reshard_array``), so a directory written on P ranks
restores onto any P′.  A placement may also be ``(mesh, spec)``, a
parameter spec (``distributed.sharding``: a tuple of axis entries): the
leaf is a model parameter's or AdamW moment's block.  ``save(...,
shardings=...)`` gathers such leaves into the global arrays (a collective:
every rank of the mesh calls ``save``) and rank 0 writes them, so a
checkpoint of a sharded model holds what the reference's holds and
restores onto any mesh, or onto one device.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

_SEP = "__"

#: torch dtypes numpy cannot hold -> (the same-width torch integer view, its
#: numpy twin, the numpy dtype stored on disk)
_VIEWS = {torch.bfloat16: (torch.int16, np.int16, np.uint16)}


def _paths(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` pairs in the reference's order: dict keys sorted,
    sequences by index; ``None`` is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in _paths(v, prefix + (i,))]
    return [(prefix, tree)]


def _treedef(tree: Any) -> str:
    """The tree's structure, written as the reference's ``PyTreeDef`` prints it."""
    def walk(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(walk(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(walk(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({walk(tree)})"


def _unflatten(tree: Any, leaves: list) -> Any:
    """``tree``'s structure with its leaves replaced, in :func:`_paths` order."""
    it = iter(leaves)

    def walk(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: walk(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            vals = [walk(v) for v in t]
            # a NamedTuple (AdamW's state) takes its fields positionally
            return type(t)(*vals) if hasattr(t, "_fields") else type(t)(vals)
        return next(it)
    return walk(tree)


def _name(path: tuple) -> str:
    return _SEP.join(str(p) for p in path)


def _to_safe(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _VIEWS:
            view, _, stored = _VIEWS[t.dtype]
            return t.view(view).numpy().view(stored)
        return t.numpy()
    return np.asarray(leaf)


def _from_safe(arr: np.ndarray, like: Any) -> Any:
    if isinstance(like, torch.Tensor):
        if like.dtype in _VIEWS:
            _, np_view, stored = _VIEWS[like.dtype]
            t = torch.from_numpy(arr.view(stored).astype(np_view))
            return t.view(like.dtype).to(like.device)
        np_dtype = torch.empty((), dtype=like.dtype).numpy().dtype
        return torch.from_numpy(arr.astype(np_dtype)).to(like.device)
    if hasattr(like, "dtype"):
        return arr.astype(like.dtype)
    return arr


def save(state: Any, directory: str, step: int, *, keep: int = 3,
         background: bool = False, shardings: Any = None) -> threading.Thread | None:
    """Write ``state`` to ``directory/step_<n>``; prune old steps.  The
    leaves are copied to the host before this returns, also with
    ``background=True`` (which then writes them on a thread).
    ``shardings`` (a prefix tree of ``(mesh, spec)`` placements, see the
    module's docstring) gathers the blocks it covers into global arrays,
    one leaf at a time on the blocks' device; only the mesh's rank 0
    copies them to the host and writes (the other ranks drop each gathered
    leaf at once), and every rank returns once the step is on disk (unless
    ``background``)."""
    treedef = _treedef(state)
    leaves = _paths(state)
    placements = _placements(shardings, state)
    mesh = next((pl[0] for pl in placements if pl is not None), None)
    writer = mesh is None or mesh.rank == 0
    flat = {}
    for (p, leaf), placement in zip(leaves, placements):
        if placement is not None:
            from repro_torch.distributed.sharding import gather_block
            leaf = gather_block(leaf, placement[1], placement[0])
        if writer:
            flat[_name(p)] = _to_safe(leaf)
        del leaf

    def write():
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        for k, v in flat.items():
            np.save(os.path.join(tmp, k + ".npy"), v)
        manifest = {"step": step, "treedef": treedef, "keys": sorted(flat)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _prune(directory, keep)

    if not writer:
        if not background:
            mesh.comm.barrier()
        return None
    if background:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    if mesh is not None:
        mesh.comm.barrier()
    return None


def _prune(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _is_placement(node: Any) -> bool:
    """A ``(mesh, layout)`` pair of ``restore``'s ``shardings``."""
    from repro_torch.launch.mesh import Mesh
    return isinstance(node, tuple) and len(node) == 2 and isinstance(node[0], Mesh)


def _placements(shardings: Any, template: Any) -> list:
    """One placement (or None) per leaf of ``template``, in :func:`_paths`
    order: a prefix tree's leaf covers the whole subtree under it."""
    if shardings is None or _is_placement(shardings):
        return [shardings] * len(_paths(template))
    if isinstance(shardings, dict) and isinstance(template, dict):
        return [p for k in sorted(template) for p in _placements(shardings.get(k), template[k])]
    if isinstance(shardings, (list, tuple)) and isinstance(template, (list, tuple)):
        if len(shardings) != len(template):
            raise ValueError(f"shardings {shardings!r} do not fit the template's "
                             f"{len(template)} entries")
        return [p for s, t in zip(shardings, template) for p in _placements(s, t)]
    raise ValueError(f"shardings {shardings!r} are not a prefix of the template")


def _place(arr: np.ndarray, like: Any, placement) -> Any:
    """The leaf restored: as its template leaf, or this rank's block of it
    on the template tensor's device (the CPU for a numpy template)."""
    if placement is None:
        return _from_safe(arr, like)
    mesh, layout = placement
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    if isinstance(layout, tuple):               # a parameter spec
        from repro_torch.distributed.sharding import block_of, set_spec
        host = _from_safe(arr, torch.empty((), dtype=like.dtype))
        return set_spec(block_of(host, layout, mesh).contiguous().to(device), layout)
    from repro_torch.runtime.elastic import reshard_array
    return reshard_array(_from_safe(arr, like), mesh, layout, device=device)


def restore(template: Any, directory: str, step: int | None = None,
            shardings: Any = None) -> tuple[Any, int]:
    """Restore into the structure of ``template`` (the latest step unless
    ``step`` is given); each leaf takes its template leaf's dtype and, for a
    tensor, its device.  ``shardings`` (a prefix tree of ``(mesh, layout)``
    or ``(mesh, spec)`` placements) places the leaves it covers as this
    rank's blocks, the elastic restore onto the current mesh (a parameter
    block carries its spec).  Returns ``(state, step)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    leaves = _paths(template)
    out = [_place(np.load(os.path.join(d, _name(p) + ".npy")), leaf, placement)
           for (p, leaf), placement in zip(leaves, _placements(shardings, template))]
    return _unflatten(template, out), step
