"""Fault-tolerant trainer on one device (counterpart of
``repro/launch/train.py``).

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
manual_seed(0), dtype)``, the data from ``--seed``.  One process, one
device: under a process group of more than one rank the trainer refuses, as
``runtime.elastic.reshard_state`` does (sharding the parameters and the
optimizer state over ranks is the next slice of the training half).
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.core.problems import resolve_device
from repro_torch.data.pipeline import PipelineConfig, Prefetcher, SyntheticSource, batches
from repro_torch.distributed.compression import init_error_feedback, make_ef_int8_transform
from repro_torch.models import steps as steps_mod
from repro_torch.models.convert import reference_name
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import adamw
from repro_torch.optim.schedules import for_arch
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.elastic import MESH_NOT_PORTED
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
    args = ap.parse_args(argv)

    if _world_size() > 1:
        raise NotImplementedError(MESH_NOT_PORTED)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dtype = getattr(torch, args.dtype, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"--dtype {args.dtype!r} is not a torch floating dtype")
    device = resolve_device(args.device)
    model = init_params(cfg, torch.Generator(device).manual_seed(0), dtype)
    ctx = model.ctx
    opt = adamw(for_arch(cfg.name, args.lr, args.steps))
    params = dict(model.named_parameters())
    # one int8 scale a layer stack, as the reference's stacked leaves have
    grad_transform = (make_ef_int8_transform({k: reference_name(cfg, k) for k in params})
                      if args.compress else None)
    step_fn = steps_mod.make_train_step(ctx, opt, grad_transform, accum=args.accum)

    opt_state = opt.init(params)
    extra = init_error_feedback(params) if args.compress else None
    start_step = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        (restored, opt_state), start_step = ckpt.restore(
            ({k: p.detach() for k, p in params.items()}, opt_state), args.ckpt_dir)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(restored[k])
        del restored
        print(f"[train] resumed from step {start_step}")

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
                print(f"[monitor] step {step}: straggler suspected "
                      f"({report['step_time']:.2f}s vs median "
                      f"{report['median']:.2f}s)")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                ckpt.save(({k: p.detach() for k, p in params.items()}, opt_state),
                          args.ckpt_dir, step + 1, background=False)
            injector.maybe_fail(step)
            print(f"[train] step {step} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f}")
    except SimulatedFailure as e:
        print(f"[train] {e} — state is checkpointed; rerun to resume")
        return {"failed_at": args.fail_at, "losses": losses}
    finally:
        data.close()
    dt = time.time() - t0
    print(f"[train] done: {len(losses)} steps in {dt:.1f}s, "
          f"final loss {losses[-1]:.4f}")
    return {"losses": losses, "final_params": model, "grad_norms": grad_norms,
            "step_s": step_s}


if __name__ == "__main__":
    main()
