"""Serving entry points behind one CLI (counterpart of ``repro/launch/serve.py``):
``--mode solver`` (default ``lm``, as in the reference).

``lm``     — batched LM decode: prefill once, then greedy autoregressive
             decode (``models/``; every family of the ten configs, seeded
             weights from ``--seed``; an enc-dec model's source frames
             drawn from the prompt's generator).
``solver`` — the solver service (``repro_torch.serve``): replay a
             mixed-workload trace through continuous batching over the
             executable cache, print SLO metrics, optionally inject a
             preemption to exercise the WAL recovery path.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --batch 4 --prompt-len 64 --gen 32                     # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --reduced --device cpu --json                          # tiny, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-moe-235b-a22b --reduced --device cpu --json   # tiny MoE
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch mamba2-780m --reduced --device cpu --json           # tiny SSM
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-large-v2 --reduced --device cpu --json # tiny enc-dec
    PYTHONPATH=src python -m repro_torch.launch.serve --mode solver \
        --kernels --scale 2 --fail-at 3 --json                 # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --mode solver \
        --device cpu --buckets smoke --json                    # plain versions

``--device`` (default ``cuda``; asking for it where there is no card fails,
it never falls back to the CPU) and ``--kernels`` (the reference's Pallas
route) are ``launch/solve.py``'s.
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def lm_generate(ctx, params, batch: dict, gen: int) -> dict:
    """Prefill ``batch`` once, then ``gen`` greedy decode steps (the
    reference's ``_lm_main`` loop) under ``torch.inference_mode()``.

    For the ssm and hybrid families the prefill is the reference's replay:
    no prefill yields an SSM state, so the prompt's tokens go one by one
    through decode steps (token i at position i) from ``init_caches``, and
    the replay's last logits give the first token.  The reference also runs
    a full forward there, whose logits the replay overwrites; the port does
    not run it.  For an enc-dec model ``batch`` also holds ``src_embeds``
    and ``src_positions``: the prefill runs the encoder once and builds the
    caches and each decoder layer's cross kvs, which every decode step reads.

    Returns ``tokens`` (B, gen + 1): the prefill's argmax, then each step's;
    ``prefill_logits`` (B, V): the prefill's last-position logits, whose
    argmax is the first token; ``prefill_s`` (prefill and cache build, or
    the replay) and ``decode_s`` (the decode loop), each ended by a device
    synchronise; ``tokens_per_s`` = B·gen / decode_s; ``finite``: every
    logit of the prefill (each replay step's) and of each step was
    finite."""
    from repro_torch.models import steps as steps_mod
    from repro_torch.models.decode import caches_from_prefill, init_caches
    from repro_torch.models.transformer import layer_kind

    dev = torch.device(ctx.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    lead = batch["tokens"] if "tokens" in batch else batch["embeds"]
    B, P = lead.shape[0], lead.shape[1]
    dstep = steps_mod.make_decode_step(ctx)
    cross = ()              # an enc-dec model's decode steps also take its cross kvs
    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        if layer_kind(ctx.cfg) in ("ssm", "hybrid"):
            caches = init_caches(ctx, B, P + gen)
            finite = torch.ones((), dtype=torch.bool, device=dev)
            for i in range(P):
                logits, caches = dstep(params, batch["tokens"][:, i:i + 1], i, caches)
                finite &= torch.isfinite(logits).all()
        else:
            logits, kvs = steps_mod.make_prefill(ctx)(params, batch)
            caches = caches_from_prefill(ctx, kvs, P + gen)
            if ctx.cfg.enc_dec:
                caches, cross_kvs = caches
                cross = (cross_kvs,)
            del kvs
            finite = torch.isfinite(logits).all()
        sync()
        t_prefill = time.perf_counter() - t0
        prefill_logits = logits[:, -1]
        tok = prefill_logits.argmax(dim=-1)[:, None]
        out_tokens = [tok]
        t0 = time.perf_counter()
        for i in range(gen):
            logits, caches = dstep(params, tok, P + i, caches, *cross)
            finite &= torch.isfinite(logits).all()
            tok = logits[:, -1].argmax(dim=-1)[:, None]
            out_tokens.append(tok)
        sync()
        t_decode = time.perf_counter() - t0
    return {"tokens": torch.cat(out_tokens, dim=1), "prefill_logits": prefill_logits,
            "prefill_s": t_prefill, "decode_s": t_decode,
            "tokens_per_s": B * gen / max(t_decode, 1e-9), "finite": bool(finite)}


def _lm_main(args) -> dict:
    from repro_torch.configs.base import get_config
    from repro_torch.core.problems import resolve_device
    from repro_torch.models.steps import SRC_FRACTION
    from repro_torch.models.transformer import init_params

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dtype = getattr(torch, args.dtype, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"--dtype {args.dtype!r} is not a torch floating dtype")
    device = resolve_device(args.device)
    params = init_params(cfg, torch.Generator(device).manual_seed(args.seed), dtype)
    B, P = args.batch, args.prompt_len
    g = torch.Generator(device).manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), device=device, generator=g)
    positions = torch.arange(P, device=device).expand(B, P)
    if cfg.mrope:
        positions = positions[None].expand(3, B, P)
    batch = {"tokens": prompt, "positions": positions}
    if cfg.enc_dec:          # the audio stub's frames: standard normal, P / 4 of them
        T = max(P // SRC_FRACTION, 1)
        batch["src_embeds"] = torch.randn((B, T, cfg.d_model), device=device,
                                          generator=g).to(dtype)
        batch["src_positions"] = torch.arange(T, device=device).expand(B, T)
    out = lm_generate(params.ctx, params, batch, args.gen)
    gen = out["tokens"].tolist()
    print(f"[serve] arch={cfg.name} batch={B} prompt={P} gen={args.gen} "
          f"dtype={args.dtype} device={device} prefill {out['prefill_s']:.2f}s "
          f"decode {out['decode_s']:.2f}s ({out['tokens_per_s']:.1f} tok/s)")
    print(f"[serve] sample continuation ids: {gen[0][:16]}")
    if args.json:
        print(json.dumps({"mode": "lm", "arch": cfg.name, "device": str(device),
                          "dtype": args.dtype, "batch": B, "prompt_len": P,
                          "gen": args.gen, "tokens": gen, "finite": out["finite"],
                          "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
                          "tokens_per_s": out["tokens_per_s"]}))
    return dict(out, arch=cfg.name, device=str(device))


def _solver_main(args) -> dict:
    from repro_torch.runtime.monitor import FailureInjector
    from repro_torch.serve import (MIXED_BUCKETS, SMOKE_BUCKETS, ServeConfig,
                                   SolverService, generate_trace, replay)

    if args.trace:
        from repro_torch.obs import trace as obs
        obs.enable(args.trace)   # equivalent: REPRO_TRACE=PATH
    cfg = ServeConfig(max_batch=args.max_batch,
                      cache_capacity=args.cache_capacity,
                      async_compile=not args.sync_compile,
                      recovery_dir=args.recovery_dir,
                      kernels=args.kernels, device=args.device)
    injector = (FailureInjector(args.fail_at)
                if args.fail_at is not None else None)
    service = SolverService(cfg, injector=injector)
    recovered = service.recover()
    if recovered:
        print(f"[serve] recovered {len(recovered)} orphaned request(s) "
              f"from {cfg.recovery_dir}")
    buckets = SMOKE_BUCKETS if args.buckets == "smoke" else MIXED_BUCKETS
    trace = generate_trace(buckets, seed=args.seed, scale=args.scale)
    results = replay(service, trace)
    service.close()
    snap = service.snapshot()

    n_buckets = len({r.key() for r in trace})
    print(f"[serve] mode=solver: {len(results)}/{len(trace)} requests over "
          f"{n_buckets} buckets  max_batch={cfg.max_batch} "
          f"cache_capacity={cfg.cache_capacity} device={cfg.device}"
          f"{' [kernels]' if cfg.kernels else ''}")
    print(f"[serve] qps={snap['qps']:.2f}  p50={snap['p50_s']*1e3:.0f}ms  "
          f"p95={snap['p95_s']*1e3:.0f}ms  p99={snap['p99_s']*1e3:.0f}ms  "
          f"preemptions={snap['preemptions']} requeued={snap['requeued']}")
    c = snap["cache"]
    print(f"[serve] cache: hits={c['hits']} misses={c['misses']} "
          f"evictions={c['evictions']} entries={c['entries']}")
    for b, st in c["per_bucket"].items():
        print(f"    {b}: compiles={st['misses']} "
              f"compile_s={st['compile_s']:.2f} batches={st['hits']}")
    out = {"mode": "solver", "requests": len(trace),
           "completed": len(results), "dropped": len(trace) - len(results),
           **{k: v for k, v in snap.items() if k != "t"}}
    if args.json:
        print(json.dumps(out))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("lm", "solver"), default="lm",
                    help="lm = batched prefill and greedy decode (every "
                         "family of the ten configs); solver = the "
                         "repro_torch.serve solver service replaying a mixed trace")
    # -- lm mode (the reference's flags) ----------------------------------------
    ap.add_argument("--arch", default=None, help="(lm) model config name")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--dtype", default="float32",
                    help="(lm) the weights' and activations' torch dtype")
    # -- solver mode -----------------------------------------------------------
    ap.add_argument("--scale", type=int, default=1,
                    help="(solver) trace size multiplier per bucket")
    ap.add_argument("--buckets", choices=("mixed", "smoke"), default="mixed",
                    help="(solver) reference mix to replay: mixed = the "
                         "reference mix, smoke = tiny grids")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="(solver) append repro.obs/v1 records (serve "
                         "lifecycle spans + SLO events) to PATH; equivalent "
                         "to REPRO_TRACE=PATH")
    ap.add_argument("--seed", type=int, default=0,
                    help="(lm) the weights' generator seed, the prompt's (and "
                         "an enc-dec model's source frames after it) seed + 1; "
                         "(solver) the trace's")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="(solver) padded in-flight batch size per bucket")
    ap.add_argument("--cache-capacity", type=int, default=8,
                    help="(solver) LRU bound on resident executables")
    ap.add_argument("--sync-compile", action="store_true",
                    help="(solver) build inline instead of a background "
                         "thread")
    ap.add_argument("--recovery-dir", default=None,
                    help="(solver) write-ahead journal dir (enables "
                         "preemption recovery)")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="(solver) inject a preemption at dispatch N "
                         "(exercises the recovery path)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (solver: the kernels' plain "
                         "versions)")
    ap.add_argument("--kernels", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="(solver) run the buckets on the hand-written CUDA "
                         "kernels (the reference's --pallas)")
    ap.add_argument("--json", action="store_true",
                    help="also print the record as JSON (lm: the tokens, "
                         "prefill seconds and decode tokens/s)")
    args = ap.parse_args(argv)

    if args.mode == "solver":
        return _solver_main(args)
    if args.arch is None:
        ap.error("--arch is required for --mode lm")
    return _lm_main(args)


if __name__ == "__main__":
    main()
