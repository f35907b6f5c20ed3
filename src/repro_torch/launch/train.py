"""Fault-tolerant trainer, on one device or on a ``data`` × ``model`` mesh
of ranks (counterpart of ``repro/launch/train.py``).

Wires the layers together: seeded init -> deterministic data pipeline
(prefetched on a host thread) -> train step (``models.steps.
make_train_step``, optionally with int8 + error-feedback gradient
compression and gradient accumulation) -> heartbeat/straggler monitor ->
checkpointing -> restart/resume.

Examples
--------
# tiny CPU run of the reduced internlm2 config with checkpointing:
PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b --reduced \
    --device cpu --steps 20 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

# internlm2-1.8b at full width and depth on the card (f32, B = 8, S = 128):
PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b --steps 10

# simulate a preemption at step 10, then resume to completion:
... --fail-at 10; rerun the same command to resume from the checkpoint.

``main`` returns ``{"losses", "final_params"}`` (the model), with each
step's ``grad_norms`` and host seconds ``step_s`` (batch upload, step and
the loss read, which waits for the device), or ``{"failed_at", "losses"}``
after an injected failure.

``--device`` defaults to ``cuda``: asking for it where there is no card
fails (``core.problems.resolve_device``), it never falls back to the CPU.
The weights come from ``init_params(cfg, torch.Generator(device).
manual_seed(0), dtype)``, the data from ``--seed``.

Under ``torchrun`` (more than one process) every rank joins the
``env://`` group (``launch.solve.init_ranks``; ``--backend`` nccl, one card
a rank, or gloo, which several ranks on one card need) and trains on
``make_mesh_for_devices()``'s ``data`` × ``model`` mesh: the parameters
and AdamW moments are this rank's blocks (``init_params`` with the mesh:
the one-device draws, each layer cut to its blocks as it is drawn, so no
rank holds the whole model), and every rank reads the
shard-0 stream at the global ``--batch`` and computes its dp rows of it,
as the reference's trainer does, so a mesh trains on the one-device run's
tokens.  ``--compress``, ``--accum``, ``--ckpt-dir`` (global arrays,
written by rank 0), ``--fail-at`` and resume work there too; rank 0
prints.  The ssm, hybrid and enc-dec families refuse a mesh
(``models.transformer.MESH_NOT_PORTED``).

# the reduced internlm2 on 2 gloo ranks of the CPU (a (1, 2) mesh):
PYTHONPATH=src torchrun --nproc_per_node 2 -m repro_torch.launch.train \
    --arch internlm2-1.8b --reduced --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.core.problems import resolve_device
from repro_torch.data.pipeline import PipelineConfig, Prefetcher, SyntheticSource, batches
from repro_torch.distributed import sharding
from repro_torch.distributed.compression import init_error_feedback, make_ef_int8_transform
from repro_torch.launch.mesh import BACKENDS, make_mesh_for_devices
from repro_torch.launch.solve import init_ranks
from repro_torch.models import steps as steps_mod
from repro_torch.models.convert import reference_name
from repro_torch.models.transformer import MESH_FAMILIES, MESH_NOT_PORTED, init_params
from repro_torch.optim.adamw import AdamWState, adamw
from repro_torch.optim.schedules import for_arch
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.monitor import FailureInjector, Heartbeat, SimulatedFailure


def _world_size() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def to_device(host_batch: dict, device: torch.device) -> dict:
    """The pipeline's numpy batch as tensors on ``device`` (ids and
    positions int64, floats as they are)."""
    out = {}
    for k, v in host_batch.items():
        t = torch.from_numpy(v)
        out[k] = (t.long() if not t.is_floating_point() else t).to(device)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (the widths stay)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--compress", action="store_true",
                    help="int8 + error-feedback gradient compression")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails where there is no card) or cpu")
    ap.add_argument("--backend", default=None, choices=list(BACKENDS),
                    help="the process group's backend under torchrun (default: nccl "
                         "on cuda, gloo on cpu; several ranks on one card need gloo)")
    ap.add_argument("--json", action="store_true",
                    help="print the run's losses and grad norms as a JSON line last")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if _world_size() > 1 and (cfg.family not in MESH_FAMILIES or cfg.enc_dec):
        raise NotImplementedError(f"{cfg.name}: {MESH_NOT_PORTED}")
    dtype = getattr(torch, args.dtype, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"--dtype {args.dtype!r} is not a torch floating dtype")
    device = resolve_device(args.device)
    device, made_group = init_ranks(args.backend, str(device))
    try:
        return _train(args, cfg, dtype, torch.device(device))
    finally:
        if made_group:
            torch.distributed.destroy_process_group()


def _say(mesh, *args) -> None:
    if mesh is None or mesh.rank == 0:
        print(*args)


def _train(args, cfg, dtype, device) -> dict:
    mesh = make_mesh_for_devices() if _world_size() > 1 else None
    shardings = None
    model = init_params(cfg, torch.Generator(device).manual_seed(0), dtype, mesh=mesh)
    ctx = model.ctx
    opt = adamw(for_arch(cfg.name, args.lr, args.steps))
    params = dict(model.named_parameters())
    if mesh is not None:
        placed = {k: (mesh, sharding.spec_of(p)) for k, p in params.items()}
        shardings = (placed, AdamWState(step=None, m=placed, v=placed))
    # one int8 scale a layer stack, as the reference's stacked leaves have
    # (on a mesh the largest magnitude over every block of the stack)
    grad_transform = None
    if args.compress:
        groups = {k: reference_name(cfg, k) for k in params}
        grad_transform = make_ef_int8_transform(
            groups, mesh=mesh,
            axes=None if mesh is None else {k: sharding.sharded_axes(sharding.spec_of(p))
                                            for k, p in params.items()})
    step_fn = steps_mod.make_train_step(ctx, opt, grad_transform, accum=args.accum)

    opt_state = opt.init(params)
    extra = init_error_feedback(params) if args.compress else None
    start_step = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        (restored, opt_state), start_step = ckpt.restore(
            ({k: p.detach() for k, p in params.items()}, opt_state), args.ckpt_dir,
            shardings=shardings)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(restored[k])
        del restored
        _say(mesh, f"[train] resumed from step {start_step}")

    pipe_cfg = PipelineConfig(
        batch_size=args.batch, seq_len=args.seq, n_shards=1, shard=0,
        seed=args.seed, mrope=cfg.mrope, frontend=cfg.frontend,
        d_model=cfg.d_model, enc_dec=cfg.enc_dec,
        src_fraction=steps_mod.SRC_FRACTION)
    source = SyntheticSource(cfg.vocab_size, args.seed)
    data = Prefetcher(batches(source, pipe_cfg, start_step))

    hb = Heartbeat()
    injector = FailureInjector(args.fail_at)
    losses, grad_norms, step_s = [], [], []
    t0 = time.time()
    try:
        for step in range(start_step, args.steps):
            t_step = time.perf_counter()
            batch = to_device(next(data), device)
            opt_state, extra, metrics = step_fn(model, opt_state, extra, batch)
            loss = float(metrics["loss"])          # waits for the step
            step_s.append(time.perf_counter() - t_step)
            losses.append(loss)
            grad_norms.append(float(metrics["grad_norm"]))
            report = hb.tick()
            if report.get("straggler"):
                _say(mesh, f"[monitor] step {step}: straggler suspected "
                           f"({report['step_time']:.2f}s vs median "
                           f"{report['median']:.2f}s)")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                ckpt.save(({k: p.detach() for k, p in params.items()}, opt_state),
                          args.ckpt_dir, step + 1, background=False, shardings=shardings)
            injector.maybe_fail(step)
            _say(mesh, f"[train] step {step} loss {loss:.4f} "
                       f"lr {float(metrics['lr']):.2e} "
                       f"gnorm {float(metrics['grad_norm']):.3f}")
    except SimulatedFailure as e:
        _say(mesh, f"[train] {e} — state is checkpointed; rerun to resume")
        return {"failed_at": args.fail_at, "losses": losses}
    finally:
        data.close()
    dt = time.time() - t0
    _say(mesh, f"[train] done: {len(losses)} steps in {dt:.1f}s, "
               f"final loss {losses[-1]:.4f}")
    if args.json:
        _say(mesh, json.dumps({"losses": losses, "grad_norms": grad_norms, "step_s": step_s,
                               "mesh": None if mesh is None else mesh.shape}))
    return {"losses": losses, "final_params": model, "grad_norms": grad_norms,
            "step_s": step_s, "mesh": mesh}


if __name__ == "__main__":
    main()
