"""Gradient compression with error feedback (the port's copy of
``repro/distributed/compression.py``, over named tensors).

Multi-pod data parallelism pays one gradient all-reduce over the slow links
per step.  The classic mitigation, implemented here:

  * int8 quantisation with one scale a tensor or group of tensors (8x
    traffic reduction),
  * error feedback (EF-SGD): the quantisation residual is carried into the
    next step, preserving convergence to first order,
  * wired into ``launch/train.py`` as the ``grad_transform`` hook of
    ``models.steps.make_train_step``.

``torch.round`` rounds half to even, as ``jnp.round`` does, so the codes are
the reference's wherever ``x / scale`` is.
"""

from __future__ import annotations

import torch


def _quantize(x: torch.Tensor, amax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x's int8 codes and scale, given the largest magnitude to scale by."""
    amax = torch.clamp(amax, min=1e-30)
    # a true division: PyTorch's CUDA divide by a Python number multiplies
    # by its reciprocal, which rounds twice
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return _quantize(x, torch.max(torch.abs(x)))


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale


def init_error_feedback(params: dict) -> dict:
    """One f32 zero residual a named tensor."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def make_ef_int8_transform(groups: dict | None = None, *, mesh=None,
                           axes: dict | None = None):
    """A ``grad_transform`` for ``models.steps.make_train_step``.

    grads' = dequant(quant(grads + ef)); ef' = (grads + ef) - grads'.

    One scale a tensor, or, with ``groups`` (name → group key), one scale a
    group: the tensors of a group are quantised as one array would be (the
    largest magnitude over all of them).  The trainer groups a model's
    layers as the reference stacks them (``models.convert.reference_name``),
    since the reference's scale is one a stacked (L, ...) leaf.

    On a mesh the tensors are this rank's blocks: ``axes`` (name → the mesh
    axes its block is sharded on, the same for every tensor of a group)
    makes each group's largest magnitude the whole leaf's or stack's, a max
    over its shards, as on one device.
    """

    def key_of(k):
        return groups[k] if groups is not None else k

    def transform(grads: dict, ef_state: dict):
        g32 = {k: g.float() + ef_state[k] for k, g in grads.items()}
        amax: dict = {}
        for k, x in g32.items():
            key = key_of(k)
            m = torch.max(torch.abs(x))
            amax[key] = m if key not in amax else torch.maximum(amax[key], m)
        if mesh is not None:
            by_axes: dict = {}
            for k in g32:
                by_axes.setdefault(tuple(axes[k]), {})[key_of(k)] = None
            for ax, keys in by_axes.items():
                if ax:
                    top = mesh.axis_comm(ax).max(torch.stack([amax[q] for q in keys]))
                    amax.update(zip(keys, top.unbind(0)))
        new_grads, new_ef = {}, {}
        for k, x in g32.items():
            q, s = _quantize(x, amax[key_of(k)])
            gq = dequantize_int8(q, s)
            new_grads[k], new_ef[k] = gq.to(grads[k].dtype), x - gq
        return new_grads, new_ef

    return transform
