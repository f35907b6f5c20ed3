#!/usr/bin/env python3
"""The LM training step on a ``data`` x ``model`` mesh of NCCL ranks, one card
a rank: the NCCL side of ``Mesh.axis_comm`` and of the sharded step, which
``chip_smoke.py`` (one card: gloo ranks share it, NCCL only at one rank) does
not reach.

    torchrun --standalone --nproc_per_node 4 chip_train_mesh_nccl.py [--record PATH]

Every rank, on its own card: (a) the axis collectives on both axes of the
(2, 2) mesh against their definitions, bitwise (all-gather along a dim, the
rank-ordered sum, the max, the reduce-scatter); (b) ``chip_smoke.py``'s (t5)
yardstick, 3 one-device steps of internlm2-1.8b at full width cut to 2
layers (each card computes the same bits), then the (2, 2) and the (1, 4)
mesh steps against it with (t5)'s bounds (``chip_smoke._check_t5``).  Rank
0 prints each run's losses, step seconds and peak GB beside the card's name
and power limit, and a JSON line last; any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

import chip_smoke as cs  # puts src/ on the path
from repro_torch.launch.mesh import Mesh  # noqa: E402


def axis_checks(mesh, dev) -> dict:
    """Each collective of each axis against its definition, bitwise."""
    out = {}
    for axis in mesh.axis_names:
        comm = mesh.axis_comm(axis)
        gen = torch.Generator(dev).manual_seed(100 + mesh.rank)
        t = torch.randn((6, 4, 1 << 16), generator=gen, device=dev, dtype=torch.float64)
        parts = comm.all_gather(t[None], dim=0)
        ordered = parts[0]
        for i in range(1, comm.size):
            ordered = ordered + parts[i]
        out[axis] = dict(
            gather=torch.equal(comm.all_gather(t, dim=1), torch.cat(parts.unbind(0), dim=1)),
            own=torch.equal(parts[comm.index], t),
            sum=torch.equal(comm.sum(t), ordered),
            max=torch.equal(comm.max(t), parts.amax(dim=0)),
            reduce_scatter=torch.equal(comm.reduce_scatter(t, dim=1),
                                       ordered.narrow(1, comm.index * 2, 2)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available() or "LOCAL_RANK" not in os.environ:
        print("chip_train_mesh_nccl: run it under torchrun on a host with CUDA cards",
              file=sys.stderr)
        return 1
    local = int(os.environ["LOCAL_RANK"])
    torch.cuda.set_device(local)
    dev = torch.device("cuda", local)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", timeout=datetime.timedelta(seconds=300), device_id=dev)
    rank, world, card = dist.get_rank(), dist.get_world_size(), cs.card_line()
    try:
        t0 = time.perf_counter()
        rec = {"axis": axis_checks(Mesh.from_default_group((2, 2), ("data", "model")), dev)}
        ok = all(all(v.values()) for v in rec["axis"].values())
        flags = torch.tensor([int(not ok)], device=dev)
        dist.all_reduce(flags)
        cs.check(int(flags) == 0, f"axis collectives differ from their definitions: {rec}")
        cut = dataclasses.replace(cs.get_config(cs.LM_ARCH), n_layers=cs.TRAIN_CUT_LAYERS)
        ref = cs.mesh_reference_steps(cut, dev)
        for shape in ((2, 2), (1, 4)):
            run = cs.mesh_train_run(shape, ref, cut, dev)
            cs._check_t5(f"nccl {shape}", run, ref, bitwise=False)
            rec[str(shape)] = run
            if rank == 0:
                print(f"[nccl] {shape}: losses {run['loss']} (one device {ref['loss']}), "
                      f"grad/m/v worst {max(c['grads'][0] for c in run['compare']):.3e}/"
                      f"{max(c['m'][0] for c in run['compare']):.3e}/"
                      f"{max(c['v'][0] for c in run['compare']):.3e}; steps "
                      f"{[round(x, 4) for x in run['step_s']]}s, peak {run['peak_gb']:.2f} GB "
                      f"a rank; on {card}", flush=True)
        rec["seconds"] = time.perf_counter() - t0
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(f"[nccl] {world} ranks, one card each: axis collectives bitwise, (2, 2) and (1, 4) "
              f"within (t5)'s bounds, {rec['seconds']:.2f}s; on {card}")
        if args.record:
            Path(args.record).parent.mkdir(parents=True, exist_ok=True)
            Path(args.record).write_text(json.dumps({"card": card, **rec}, indent=1,
                                                    default=str))
        print(json.dumps({"ok": True, "ranks": world}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
