"""AdamW with f32 moments over params of any dtype + global-norm clipping.

The port's copy of ``repro/optim/adamw.py``, over named tensors: ``params``
and ``grads`` are dicts of name → tensor (a model's ``named_parameters()``
and their ``.grad``s), and the moments are dicts of the same names.  The
arithmetic is the reference's formula, in its order, in f32 whatever the
params' dtype: the grads scaled by ``min(1, clip_norm / (gnorm + 1e-9))``,
bias correction with the step as f32, and the update
``p - lr·(m̂/(√v̂ + eps) + wd·p)`` cast back to the param's dtype.  Weight
decay applies to every parameter, as in the reference.  (``torch.optim.
AdamW`` would decay with a separate multiply before the step and has no
global clip: either moves the bits.)

The step count stays on the host (an int32 0-d tensor): the schedule and
the bias corrections are computed there in f32, the same bits whatever the
params' device (PyTorch's CUDA divide by a Python number multiplies by its
reciprocal, which the reference's arithmetic does not), and then moved to
the params' device as 0-d tensors.

The master copy is elided, as in the reference: updates are computed in f32
and cast back, so a bf16 model costs 2 + 8 bytes a parameter of state.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 0-d, on the host
    m: dict
    v: dict


class AdamW(NamedTuple):
    init: Callable
    update: Callable


def global_norm(tree: dict) -> torch.Tensor:
    """√Σ‖leaf‖² in f32: one sum of squares a leaf, added in the dict's order."""
    total = None
    for leaf in tree.values():
        sq = torch.sum(torch.square(leaf.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def sharded_norm(tree: dict, *, mesh, axes: dict) -> torch.Tensor:
    """:func:`global_norm` of a tree of blocks on ``mesh``: each leaf's sum
    of squares summed over the axes ``axes[name]`` it is sharded on (a leaf
    replicated over an axis counted once), the leaves added in the dict's
    order.  One sum over each set of axes for all the leaves sharded on it
    (in rank order: the same bits on every rank)."""
    sq = {k: torch.sum(torch.square(leaf.float())) for k, leaf in tree.items()}
    by_axes: dict = {}
    for k in tree:
        by_axes.setdefault(tuple(axes[k]), []).append(k)
    for key, names in by_axes.items():
        if key:
            summed = mesh.axis_comm(key).sum(torch.stack([sq[k] for k in names]))
            sq.update(zip(names, summed.unbind(0)))
    total = None
    for k in tree:
        total = sq[k] if total is None else total + sq[k]
    return torch.sqrt(total)


def adamw(
    schedule: Callable[[torch.Tensor], torch.Tensor],
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
) -> AdamW:
    def init(params: dict) -> AdamWState:
        def zeros():
            return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for k, p in params.items()}
        return AdamWState(step=torch.zeros((), dtype=torch.int32), m=zeros(), v=zeros())

    @torch.no_grad()
    def update(grads: dict, state: AdamWState, params: dict, norm=None):
        """→ (new params, new state, {"grad_norm", "lr"}): new tensors, the
        inputs untouched.  ``grads`` has the names of ``params``.  ``norm``
        computes the clipping norm of ``grads`` (:func:`global_norm` by
        default; :func:`sharded_norm` for blocks on a mesh)."""
        step = state.step + 1
        dev = next(iter(params.values())).device
        gnorm = (norm or global_norm)(grads)
        # a Python number over a tensor is reciprocal-then-multiply in
        # PyTorch (two roundings): divide a full tensor instead
        scale = torch.clamp(torch.full_like(gnorm, clip_norm) / (gnorm + 1e-9), max=1.0)
        lr = schedule(step).to(torch.float32)
        s = step.to(torch.float32)
        c1, c2 = (1 - b1 ** s).to(dev), (1 - b2 ** s).to(dev)
        lr_dev = lr.to(dev)
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = grads[k].float() * scale
            m2 = b1 * state.m[k] + (1 - b1) * g
            v2 = b2 * state.v[k] + (1 - b2) * g * g
            mhat = m2 / c1
            vhat = v2 / c2
            p32 = p.float()
            delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p32
            new_p[k] = (p32 - lr_dev * delta).to(p.dtype)
            new_m[k], new_v[k] = m2, v2
        return new_p, AdamWState(step=step, m=new_m, v=new_v), {
            "grad_norm": gnorm, "lr": lr}

    return AdamW(init=init, update=update)
