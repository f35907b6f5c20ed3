"""The rank side of ``tests/test_torch_train_mesh.py``: what each gloo rank
of a (data, model) mesh does, and the checks that need no reference.

Imports no JAX, so the ranks start light.  The test process writes the
inputs (the reference's weights as flat numpy arrays, the batches) into the
directory named by ``REPRO_TRAIN_MESH_DIR`` and spawns the ranks through
``test_torch_distributed_ranks.spawn``; each worker returns, from rank 0,
the global trees gathered from the blocks (``convert.
reference_tree_of_blocks``), flattened to dotted names.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.distributed import sharding
from repro_torch.distributed.compression import init_error_feedback, make_ef_int8_transform
from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import Mesh
from repro_torch.models import convert, mlp, moe
from repro_torch.models import steps as port_steps
from repro_torch.models.transformer import Transformer, init_params
from repro_torch.optim import adamw as port_adamw
from repro_torch.optim import schedules as port_sched
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime import elastic

LR = 1e-3
#: the reference's three (``tests/test_distributed_lm.py``)
REF_ARCHS = ("internlm2-1.8b", "qwen3-moe-235b-a22b", "minicpm-2b")
#: the dense, vlm and moe configs held on (2, 2)
MESH_ARCHS = ("gemma2-2b", "internlm2-1.8b", "llama4-maverick-400b-a17b", "minicpm-2b",
              "qwen2-vl-7b", "qwen2.5-32b", "qwen3-moe-235b-a22b")
#: the MoE layer's drops: a capacity factor that makes them happen
DROP_CAPACITY = 0.5
TRAINER = ["--arch", "internlm2-1.8b", "--reduced", "--device", "cpu", "--batch", "4",
           "--seq", "32"]


#: widths that do not split over tp = 2 where the reference's ``_divisible``
#: still shards the weight (3 heads of 16: wq's 48 columns; d_ff 129: w_in's
#: 258) or replicates it (the vocab 257): those modules run replicated
ODD = dict(n_heads=3, n_kv_heads=1, d_ff=129, vocab_size=257)
ODD_ARCHS = ("internlm2-1.8b", "qwen2.5-32b")


def io_dir() -> str:
    return os.environ["REPRO_TRAIN_MESH_DIR"]


def load_tree(arch: str) -> dict:
    with np.load(os.path.join(io_dir(), f"{arch}.tree.npz")) as f:
        return {k: f[k] for k in f.files}


def load_batch(name: str) -> dict:
    with np.load(os.path.join(io_dir(), f"{name}.batch.npz")) as f:
        return {k: f[k] for k in f.files}


def to_batch(b: dict, dtype=torch.float32) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        dtype if v.dtype.kind == "f" else torch.int64) for k, v in b.items()}


def cast_tree(tree: dict, dtype) -> dict:
    """An f32 tree as ``dtype`` (the router stays f32, as the port holds it)."""
    if dtype == torch.float32:
        return tree
    return {k: v if k.endswith("router") else v.astype(np.float64) for k, v in tree.items()}



def recorder(store: dict, inner=None):
    """A ``grad_transform`` that keeps the step's gradients in ``store``
    and passes them to ``inner`` (or on unchanged)."""
    def transform(grads, extra):
        store.update({k: g.detach().clone() for k, g in grads.items()})
        return inner(grads, extra) if inner is not None else (grads, extra)
    return transform


def one_step(cfg, tree: dict, batch: dict, mesh, *, dtype=torch.float32, accum: int = 1,
             compress: bool = False):
    """One ``make_train_step`` from the reference's weights: on ``mesh``
    (this rank's blocks) or, with ``mesh`` None, on one device.  Returns
    (model, opt_state, extra, metrics, grads), the tensors this rank's."""
    if mesh is None:
        model = convert.params_from_reference(cfg, tree)
    else:
        model = convert.blocks_from_reference(cfg, tree, mesh)
    model.ctx = dataclasses.replace(model.ctx, dtype=dtype, device="cpu")
    params = dict(model.named_parameters())
    opt = port_adamw.adamw(port_sched.constant(LR))
    gt = extra = None
    if compress:
        axes = None if mesh is None else {k: sharding.sharded_axes(sharding.spec_of(p))
                                          for k, p in params.items()}
        gt = make_ef_int8_transform({k: convert.reference_name(cfg, k) for k in params},
                                    mesh=mesh, axes=axes)
        extra = init_error_feedback(params)
    grads: dict = {}
    step = port_steps.make_train_step(model.ctx, opt, recorder(grads, gt), accum=accum)
    state, extra, metrics = step(model, opt.init(params), extra, to_batch(batch, dtype))
    return model, state, extra, {k: float(v) for k, v in metrics.items()}, grads


def gathered(cfg, model, state, grads, mesh) -> dict:
    """The step's params, grads, m and v as the reference's flat trees."""
    specs = {k: sharding.spec_of(p) for k, p in model.named_parameters()}
    out = {}
    for part, named in (("params", {k: p.detach() for k, p in model.named_parameters()}),
                        ("grads", grads), ("m", state.m), ("v", state.v)):
        tree = (convert.reference_tree(cfg, named) if mesh is None
                else convert.reference_tree_of_blocks(cfg, named, specs, mesh))
        out[part] = convert._flatten(tree)
    return out


def _mesh_cases(rank: int, shape, archs, f64_archs) -> dict:
    mesh = Mesh.from_default_group(shape, ("data", "model"))
    out: dict = {"f32": {}, "f64": {}}
    for arch in archs:
        cfg = get_config(arch).reduced()
        model, state, _, metrics, grads = one_step(cfg, load_tree(arch), load_batch(arch), mesh)
        rec = gathered(cfg, model, state, grads, mesh)
        out["f32"][arch] = dict(metrics=metrics, **rec) if rank == 0 else None
    for arch in f64_archs:
        cfg = get_config(arch).reduced()
        model, state, _, metrics, grads = one_step(
            cfg, cast_tree(load_tree(arch), torch.float64), load_batch(arch), mesh,
            dtype=torch.float64)
        rec = gathered(cfg, model, state, grads, mesh)
        out["f64"][arch] = dict(metrics=metrics, grads=rec["grads"]) if rank == 0 else None
    return out, mesh


def moe_layer(rank: int, mesh) -> dict:
    """Layer 0's MoE of the reduced qwen3-moe (capacity factor
    ``DROP_CAPACITY``) on this rank's dp rows of a seeded (4, 32, d) input,
    forward and backward of a seeded cotangent: the output, the dropped
    assignments and the input's gradient gathered over dp, and every
    expert block's gradient gathered into the global stacks."""
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                              capacity_factor=DROP_CAPACITY)
    model = convert.blocks_from_reference(cfg, load_tree("qwen3-moe-235b-a22b"), mesh)
    model.ctx = dataclasses.replace(model.ctx, device="cpu")
    par = model.ctx.par
    io = load_batch("moe")
    x = par.rows(torch.from_numpy(io["x"]), 0).clone().requires_grad_()
    cot = par.rows(torch.from_numpy(io["cot"]), 0)
    stats: dict = {}
    layer = model.layers[0].moe
    out, aux = moe.moe_forward(layer, cfg, x, stats=stats, par=par)
    torch.autograd.backward([out, aux], [cot, torch.ones_like(aux)])
    named = {k: p.grad for k, p in layer.named_parameters()}
    specs = {k: sharding.spec_of(p) for k, p in layer.named_parameters()}
    grads = sharding.gather_params(named, specs, mesh)
    B = x.shape[0]
    return dict(path=stats["path"], capacity=stats["capacity"], aux=float(aux.detach()),
                out=par.dp.all_gather(out.detach(), dim=0),
                dropped=par.dp.all_gather(stats["dropped"].view(B, -1), dim=0),
                x_grad=par.dp.all_gather(x.grad, dim=0), grads=grads)


def reshard_round_trip(mesh) -> dict:
    """``reshard_state`` of a global state and back (bitwise), also from an
    MHA model's placement without ``cfg`` to the one with it."""
    cfg = dataclasses.replace(get_config("minicpm-2b").reduced(), n_kv_heads=4)
    gen = torch.Generator().manual_seed(7)
    names = {k: tuple(p.shape) for k, p in Transformer(
        cfg, dtype=torch.float32, device="meta").named_parameters()}
    glob = {k: torch.randn(s, generator=gen) for k, s in names.items()}
    state = port_adamw.AdamWState(step=torch.tensor(3, dtype=torch.int32),
                                  m={k: torch.randn(s, generator=gen) for k, s in names.items()},
                                  v={k: torch.rand(s, generator=gen) for k, s in names.items()})
    plain, _ = elastic.reshard_state(glob, None, mesh)            # the reference's call
    placed, st = elastic.reshard_state(plain, state, mesh, cfg, from_mesh=mesh)
    back = {k: sharding.gather_block(v, sharding.spec_of(v), mesh) for k, v in placed.items()}
    m_back = {k: sharding.gather_block(v, sharding.spec_of(v), mesh) for k, v in st.m.items()}
    ok = all(torch.equal(back[k], glob[k]) for k in glob) and all(
        torch.equal(m_back[k], state.m[k]) for k in glob) and int(st.step) == 3
    return dict(ok=ok, gqa_wk=sharding.spec_of(plain["layers.0.attn.wk"]),
                mha_wk=sharding.spec_of(placed["layers.0.attn.wk"]))


def block_draw(mesh) -> dict:
    """``init_params`` and ``moe.init_moe_params`` on ``mesh`` (each layer
    cut to its blocks as it is drawn) against the one-device draw placed
    by ``reshard_state`` with ``cfg``: per config, whether every block and
    its spec are equal (bitwise), and the names of the parameters."""
    out = {}
    mha = dataclasses.replace(get_config("minicpm-2b").reduced(), n_kv_heads=4)
    for cfg in [get_config(a).reduced() for a in MESH_ARCHS] + [mha]:
        drawn = init_params(cfg, torch.Generator().manual_seed(3), torch.float32, mesh=mesh)
        whole = init_params(cfg, torch.Generator().manual_seed(3), torch.float32)
        want, _ = elastic.reshard_state({k: p.detach() for k, p in whole.named_parameters()},
                                        None, mesh, cfg)
        got = dict(drawn.named_parameters())
        out[cfg.name + ("-mha" if cfg is mha else "")] = dict(
            names=sorted(got) == sorted(want), ctx=drawn.ctx.mesh is mesh,
            equal=all(torch.equal(got[k], want[k]) and sharding.spec_of(got[k])
                      == sharding.spec_of(want[k]) for k in want))
    cfg = get_config("llama4-maverick-400b-a17b").reduced()
    drawn = moe.init_moe_params(cfg, torch.Generator().manual_seed(4), torch.float32, mesh=mesh)
    whole = moe.init_moe_params(cfg, torch.Generator().manual_seed(4), torch.float32)
    want, _ = elastic.reshard_state({f"moe.{k}": p.detach() for k, p in whole.named_parameters()},
                                    None, mesh, cfg)
    out["moe-layer"] = dict(names=True, ctx=True, equal=all(
        torch.equal(p, want[f"moe.{k}"]) and sharding.spec_of(p) == sharding.spec_of(
            want[f"moe.{k}"]) for k, p in drawn.named_parameters()))
    return out


def odd_step(arch: str, mesh) -> dict:
    """One step of ``arch``'s reduced config with the ``ODD`` widths from
    seeded port weights (on ``mesh`` or one device), gathered: metrics,
    params, grads, m and v."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **ODD)
    model = init_params(cfg, torch.Generator().manual_seed(0), torch.float32, mesh=mesh)
    model.ctx = dataclasses.replace(model.ctx, device="cpu")
    opt = port_adamw.adamw(port_sched.constant(LR))
    grads: dict = {}
    step = port_steps.make_train_step(model.ctx, opt, recorder(grads))
    gen = torch.Generator().manual_seed(5)
    B, S = 4, 32
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen),
             "targets": torch.randint(0, cfg.vocab_size, (B, S), generator=gen),
             "positions": torch.arange(S).expand(B, S).contiguous()}
    state, _, metrics = step(model, opt.init(dict(model.named_parameters())), None, batch)
    rec = gathered(cfg, model, state, grads, mesh)
    rec["metrics"] = {k: float(v) for k, v in metrics.items()}
    rec["specs"] = {k: sharding.spec_of(p) for k, p in model.named_parameters()}
    return rec


def axis_collectives(rank: int, mesh) -> dict:
    """``Mesh.axis_comm`` on both axes of the mesh: an all-gather along dim
    1, the rank-ordered sum (bitwise the sum of the gathered parts taken in
    order), the max, the reduce-scatter (the block of that sum), and the
    refusal of a batch whose rows do not split over the dp ranks."""
    from repro_torch.distributed.collectives import Parallel
    out = {}
    for axis in ("data", "model"):
        comm = mesh.axis_comm(axis)
        gen = torch.Generator().manual_seed(100 + rank)
        t = torch.randn((3, 4, 2), generator=gen, dtype=torch.float64)
        parts = comm.all_gather(t[None], dim=0)
        gathered = comm.all_gather(t, dim=1)
        ordered = parts[0]
        for i in range(1, comm.size):
            ordered = ordered + parts[i]
        rs = comm.reduce_scatter(t, dim=1)
        out[axis] = dict(
            gather_ok=torch.equal(gathered, torch.cat(parts.unbind(0), dim=1)),
            own=torch.equal(parts[comm.index], t), size=comm.size, index=comm.index,
            sum_ok=torch.equal(comm.sum(t), ordered),
            max_ok=torch.equal(comm.max(t), parts.amax(dim=0)),
            rs_ok=torch.equal(rs, ordered.narrow(1, comm.index * 2, 2)))
    par = Parallel(mesh, ("data",), "model")
    # a GLU weight's view (each model rank's gate and up columns) through
    # the all_to_all permutation against the gathered whole, forward and
    # backward (the gradient of each block its own columns' cotangent)
    gen = torch.Generator().manual_seed(7)
    whole = torch.randn((3, 16), generator=gen, dtype=torch.float64)
    cot = torch.randn((3, 8), generator=gen, dtype=torch.float64)
    block = sharding.set_spec(whole.narrow(1, par.tp_rank * 8, 8).clone().requires_grad_(),
                              (None, "model"))
    cols = mlp.glu_ranges(par, 8)[0]
    view = par.param(block, dim=1, ranges=cols)
    view.backward(cot * (1 + par.tp_rank))
    want = torch.cat([whole.narrow(1, a, m) for a, m in cols(par.tp_rank)], dim=1)
    grad = torch.zeros_like(whole)
    for r in range(par.tp.size):
        for i, (a, m) in enumerate(cols(r)):
            grad[:, a:a + m] += (cot * (1 + r))[:, i * 4:i * 4 + m]
    out["permute_ok"] = torch.equal(view.detach(), want) and torch.equal(
        block.grad, grad.narrow(1, par.tp_rank * 8, 8))
    try:
        par.rows(torch.zeros(3, 5), 0)
        out["odd_rows_refused"] = False
    except ValueError:
        out["odd_rows_refused"] = True
    return out


def mesh22(rank: int, world: int) -> dict:
    """World 4, the (2, 2) mesh: the seven configs' f32 step and the
    reference's three in f64; accum=2 and the int8 transform (internlm2);
    the MoE layer's drops; ``reshard_state``; a checkpoint after a step
    (``checkpoint.save`` with the blocks' specs, rank 0 writing global
    arrays) and the straight run's next step."""
    out, mesh = _mesh_cases(rank, (2, 2), MESH_ARCHS, REF_ARCHS)
    out["collectives"] = axis_collectives(rank, mesh)
    out["odd"] = {arch: odd_step(arch, mesh) for arch in ODD_ARCHS}
    if rank:
        out["odd"] = None
    cfg = get_config("internlm2-1.8b").reduced()
    tree, batch = load_tree("internlm2-1.8b"), load_batch("internlm2-1.8b")
    for mode, kw in (("accum", dict(accum=2)), ("int8", dict(compress=True))):
        model, state, extra, metrics, grads = one_step(cfg, tree, batch, mesh, **kw)
        rec = gathered(cfg, model, state, grads, mesh)
        if kw.get("compress"):
            specs = {k: sharding.spec_of(p) for k, p in model.named_parameters()}
            rec["ef"] = convert._flatten(convert.reference_tree_of_blocks(cfg, extra, specs,
                                                                          mesh))
        out[mode] = dict(metrics=metrics, **rec) if rank == 0 else None
    out["moe"] = moe_layer(rank, mesh)
    out["reshard"] = reshard_round_trip(mesh)
    out["block_draw"] = block_draw(mesh)
    # a checkpoint after one step, then the straight run's next step
    model, state, _, _, _ = one_step(cfg, tree, batch, mesh)
    specs = {k: sharding.spec_of(p) for k, p in model.named_parameters()}
    placed = {k: (mesh, s) for k, s in specs.items()}
    ckpt.save(({k: p.detach() for k, p in model.named_parameters()}, state),
              os.path.join(io_dir(), "ckpt"), 1,
              shardings=(placed, port_adamw.AdamWState(step=None, m=placed, v=placed)))
    saved = gathered(cfg, model, state, {}, mesh)          # collective: every rank
    out["saved"] = saved if rank == 0 else None
    opt = port_adamw.adamw(port_sched.constant(LR))
    step = port_steps.make_train_step(model.ctx, opt)
    _, _, metrics = step(model, state, None, to_batch(load_batch("next")))
    out["next_loss"] = float(metrics["loss"])
    return out


def mesh24(rank: int, world: int) -> dict:
    """World 8, the reference's (2, 4) mesh: its three configs in f32 and f64."""
    return _mesh_cases(rank, (2, 4), REF_ARCHS, REF_ARCHS)[0]


def restore_step(cfg, mesh, directory: str):
    """The reduced internlm2 restored from ``directory`` (onto ``mesh``, or
    one device), then one step on the ``next`` batch: (the restored
    gathered trees, the step's loss)."""
    tree = load_tree("internlm2-1.8b")
    if mesh is None:
        model = convert.params_from_reference(cfg, tree)
    else:
        model = convert.blocks_from_reference(cfg, tree, mesh)
    model.ctx = dataclasses.replace(model.ctx, device="cpu")
    params = {k: p.detach() for k, p in model.named_parameters()}
    opt = port_adamw.adamw(port_sched.constant(LR))
    template = (params, opt.init(params))
    shardings = None
    if mesh is not None:
        placed = {k: (mesh, sharding.spec_of(p)) for k, p in model.named_parameters()}
        shardings = (placed, port_adamw.AdamWState(step=None, m=placed, v=placed))
    (restored, state), step_n = ckpt.restore(template, directory, shardings=shardings)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(restored[k])
    rec = gathered(cfg, model, state, {}, mesh)
    step = port_steps.make_train_step(model.ctx, opt)
    _, _, metrics = step(model, state, None, to_batch(load_batch("next")))
    return rec, float(metrics["loss"]), step_n


def mesh12(rank: int, world: int) -> dict:
    """World 2, the (1, 2) mesh: the (2, 2) checkpoint restored and its
    next step; the trainer (``launch.train.main`` on the group the harness
    made: ``make_mesh_for_devices`` gives (1, 2)) straight, with
    ``--compress --accum 2``, and failing at step 2 then resumed."""
    mesh = Mesh.from_default_group((1, 2), ("data", "model"))
    cfg = get_config("internlm2-1.8b").reduced()
    rec, loss, step_n = restore_step(cfg, mesh, os.path.join(io_dir(), "ckpt"))
    out = dict(restored=rec if rank == 0 else None, next_loss=loss, step=step_n)
    ck = os.path.join(io_dir(), "trainer_ckpt")
    out["straight"] = port_train.main(TRAINER + ["--steps", "4"])["losses"]
    out["options"] = port_train.main(TRAINER + ["--steps", "2", "--compress", "--accum", "2"])[
        "losses"]
    failed = port_train.main(TRAINER + ["--steps", "4", "--ckpt-dir", ck, "--ckpt-every", "2",
                                        "--fail-at", "2"])
    resumed = port_train.main(TRAINER + ["--steps", "4", "--ckpt-dir", ck, "--ckpt-every", "2"])
    out.update(failed_at=failed.get("failed_at"), resumed=resumed["losses"],
               mesh=resumed["mesh"].shape)
    return out
