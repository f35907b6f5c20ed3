"""The training step on a (data, model) mesh of gloo ranks against one device.

The ranks (``tests/test_torch_train_mesh_ranks.py``) run the port's
``make_train_step`` on their blocks of the reference's weights
(``models.convert.blocks_from_reference``), taking the global batch and
computing their dp rows of it; what they return is gathered back into the
reference's global trees.  Three spawned runs: (2, 2) (world 4: the seven
dense, vlm and moe configs, the f64 cases, accum=2, the int8 transform, the
MoE layer's drops, ``reshard_state``, a checkpoint), (2, 4) (world 8, the
reference's own mesh in ``tests/test_distributed_lm.py``, its three
configs) and (1, 2) (world 2: the checkpoint restored, the trainer).

Tolerances, in f32, against the reference's one-device ``make_train_step``
(JAX, in this process): loss, ce, aux and grad norm within 1e-5 relative;
m and v within 1e-4 of each leaf's largest (after one step m = 0.1·clip·g,
so this holds the gradient, the clip through the grad norm); every
gradient block, gathered, within 1e-4 of the leaf's largest against the
port's one-device gradient (itself held to the reference's in
``tests/test_torch_train.py``); the params within the reference's rtol
2e-4 / atol 2e-5, but where the two runs' gradients differ by more than
1e-3 of themselves (near 0) within 2·lr (a first AdamW step moves p by
lr·g/(|g| + eps)), those at most 1 % of the params.

In f64 the head's logits and the router are f32 (the reference's rule, in
every dtype), so a vocab split over ``model`` sums the f32 exps in another
order than one device does: the bound there is 1e-6 of each gradient
leaf's largest and 1e-6 relative on the loss (measured ≤ 6e-8 and 1e-7),
against the port's one-device f64 step; a missing or doubled sum is O(1).
The MoE layer (capacity factor 0.5 so that assignments drop): the drops
equal one device's index for index, the output within 1e-5 of its
largest, every expert block's gradient within 1e-4 of its largest.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_distributed_ranks import spawn, spawn_join, spawn_start
from test_torch_harness import ref_module
from test_torch_models import one_thread  # noqa: F401  (fixture)
from test_torch_train import GRAD_RTOL, LOSS_RTOL, _rel, get_pair, train_batch
from test_torch_train_mesh_ranks import (DROP_CAPACITY, LR, MESH_ARCHS, ODD_ARCHS, REF_ARCHS,
                                         TRAINER, cast_tree, gathered, odd_step, one_step,
                                         restore_step)

from repro_torch.configs.base import get_config
from repro_torch.launch import train as port_train
from repro_torch.models import convert, moe

ref_steps = ref_module("models.steps")
ref_adamw = ref_module("optim.adamw")
ref_sched = ref_module("optim.schedules")

PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-5
NOISE = 1e-3
F64_RTOL = 1e-6
MOE_OUT_TOL = 1e-5
TRAINER_RTOL = 1e-6
MAX_CODE_FLIPS = 10


def _flat(tree) -> dict:
    return convert._flatten(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def io(tmp_path_factory):
    """The inputs on disk, for the ranks: each config's reference tree and
    batch (B = 4, S = 32, a fifth of the positions masked), internlm2's
    next batch, the MoE layer's input and cotangent."""
    d = tmp_path_factory.mktemp("train_mesh")
    pairs = {}
    for arch in MESH_ARCHS:
        p = get_pair(arch)
        pairs[arch] = p
        np.savez(d / f"{arch}.tree.npz", **_flat(p.tree))
        np.savez(d / f"{arch}.batch.npz", **train_batch(p, 4, 32, seed=21))
    p = pairs["internlm2-1.8b"]
    np.savez(d / "next.batch.npz", **train_batch(p, 4, 32, seed=22))
    rng = np.random.default_rng(23)
    np.savez(d / "moe.batch.npz",
             x=rng.standard_normal((4, 32, p.cfg.d_model)).astype(np.float32),
             cot=rng.standard_normal((4, 32, p.cfg.d_model)).astype(np.float32))
    old = os.environ.get("REPRO_TRAIN_MESH_DIR")
    os.environ["REPRO_TRAIN_MESH_DIR"] = str(d)
    yield d, pairs
    if old is None:
        os.environ.pop("REPRO_TRAIN_MESH_DIR")
    else:
        os.environ["REPRO_TRAIN_MESH_DIR"] = old


def _batch(d, arch: str) -> dict:
    with np.load(d / f"{arch}.batch.npz") as f:
        return {k: f[k] for k in f.files}


def _tree(d, arch: str) -> dict:
    with np.load(d / f"{arch}.tree.npz") as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def started(io, tmp_path_factory):
    """(2, 2) and (2, 4) started together as soon as the inputs are on disk,
    so their ranks run while this process computes the reference's steps."""
    return {name: spawn_start(world, name, tmp_path_factory.mktemp(name))
            for name, world in (("train_mesh22", 4), ("train_mesh24", 8))}


@pytest.fixture(scope="module")
def run22(started):
    return spawn_join(started["train_mesh22"])


@pytest.fixture(scope="module")
def run24(started):
    return spawn_join(started["train_mesh24"])


@pytest.fixture(scope="module")
def run12(run22, tmp_path_factory):
    """After (2, 2): its checkpoint feeds (1, 2)."""
    return spawn(2, "train_mesh12", tmp_path_factory.mktemp("train_mesh12"))


_REF: dict = {}


def reference_step(io, arch: str) -> dict:
    """The reference's one-device step (jitted), flat: metrics, params, m, v."""
    if arch not in _REF:
        d, pairs = io
        p = pairs[arch]
        opt = ref_adamw.adamw(ref_sched.constant(LR))
        step = jax.jit(ref_steps.make_train_step(p.ctx_r, opt))
        batch = {k: jnp.asarray(v) for k, v in _batch(d, arch).items()}
        params, state, _, metrics = step(p.tree, opt.init(p.tree), None, batch)
        _REF[arch] = dict(metrics={k: float(v) for k, v in metrics.items()},
                          params=_flat(params), m=_flat(state.m), v=_flat(state.v))
    return _REF[arch]


_ONE: dict = {}


def port_one_device(io, arch: str, dtype=torch.float32, **kw) -> dict:
    """The port's one-device step from the same weights and batch, flat."""
    key = (arch, dtype, tuple(sorted(kw.items())))
    if key not in _ONE:
        d, _ = io
        cfg = get_config(arch).reduced()
        model, state, extra, metrics, grads = one_step(
            cfg, cast_tree(_tree(d, arch), dtype), _batch(d, arch), None, dtype=dtype, **kw)
        rec = gathered(cfg, model, state, grads, None)
        if extra is not None:
            rec["ef"] = convert._flatten(convert.reference_tree(cfg, extra))
        _ONE[key] = dict(metrics=metrics, **rec)
    return _ONE[key]


def _worst(got: dict, want: dict) -> tuple[float, str]:
    """The largest max |Δ| over a leaf's largest |want|, and its leaf."""
    assert sorted(got) == sorted(want)
    return max((float(np.abs(got[k].astype(np.float64) - want[k]).max()
                      / max(np.abs(want[k]).max(), 1e-30)), k) for k in want)


def _params_close(got: dict, want: dict, m_got: dict, m_want: dict) -> None:
    n_bad = n_all = 0
    for k, w in want.items():
        noise = np.abs(m_got[k] - m_want[k]) > NOISE * np.abs(m_want[k])
        diff = np.abs(got[k] - w)
        bad = diff > PARAM_ATOL + PARAM_RTOL * np.abs(w)
        assert not (bad & ~noise).any(), k
        assert (diff[noise] <= 2 * LR + PARAM_ATOL).all(), k
        n_bad, n_all = n_bad + int(bad.sum()), n_all + bad.size
    assert n_bad <= n_all // 100, (n_bad, n_all)


def _check_against_reference(rec: dict, ref: dict, one: dict) -> None:
    for k in ("loss", "ce", "grad_norm"):
        assert _rel(rec["metrics"][k], ref["metrics"][k]) <= LOSS_RTOL, k
    assert abs(rec["metrics"]["aux"] - ref["metrics"]["aux"]) <= LOSS_RTOL * max(
        ref["metrics"]["aux"], 1.0)
    for part in ("m", "v"):
        err, leaf = _worst(rec[part], ref[part])
        assert err <= GRAD_RTOL, (part, leaf, err)
    err, leaf = _worst(rec["grads"], one["grads"])
    assert err <= GRAD_RTOL, ("grads", leaf, err)
    _params_close(rec["params"], ref["params"], rec["m"], ref["m"])


CASES = [("run22", a) for a in MESH_ARCHS] + [("run24", a) for a in REF_ARCHS]


@pytest.mark.parametrize("run, arch", CASES)
def test_mesh_step_matches_reference(io, started, request, run, arch):
    ref, one = reference_step(io, arch), port_one_device(io, arch)   # while the ranks run
    _check_against_reference(request.getfixturevalue(run)[0]["f32"][arch], ref, one)


@pytest.mark.parametrize("run, arch", [(r, a) for r in ("run22", "run24") for a in REF_ARCHS])
def test_f64_mesh_step_matches_one_device(io, request, run, arch):
    rec = request.getfixturevalue(run)[0]["f64"][arch]
    one = port_one_device(io, arch, torch.float64)
    assert _rel(rec["metrics"]["loss"], one["metrics"]["loss"]) <= F64_RTOL
    err, leaf = _worst(rec["grads"], one["grads"])
    assert err <= F64_RTOL, (leaf, err)
    assert all(g.dtype == np.float64 for k, g in rec["grads"].items() if "router" not in k)


def test_axis_collectives(run22):
    """Every rank of (2, 2): its place on each axis, the gather, the
    rank-ordered sum, the max and the reduce-scatter bitwise their
    definitions; a GLU weight's gate-and-up view through the permutation,
    forward and backward, bitwise the gathered whole's; a batch that does
    not split over dp is refused."""
    for rank, r in enumerate(run22):
        rec = r["collectives"]
        assert rec["data"]["index"] == rank // 2 and rec["model"]["index"] == rank % 2
        for axis in ("data", "model"):
            assert rec[axis]["size"] == 2
            assert all(rec[axis][k] for k in ("gather_ok", "own", "sum_ok", "max_ok", "rs_ok"))
        assert rec["odd_rows_refused"] and rec["permute_ok"]


@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_one_rank_mesh_is_one_device_bitwise(io, arch):
    """A (1, 1) mesh (one rank, no group) runs the mesh code with every
    collective the identity: loss, grad norm, gradients, m, v and params
    bitwise the one-device step's."""
    from repro_torch.launch.mesh import Mesh
    d, _ = io
    cfg = get_config(arch).reduced()
    mesh = Mesh.one_rank(("data", "model"))
    model, state, _, metrics, grads = one_step(cfg, _tree(d, arch), _batch(d, arch), mesh)
    rec = gathered(cfg, model, state, grads, mesh)
    one = port_one_device(io, arch)
    assert metrics == one["metrics"]
    for part in ("params", "grads", "m", "v"):
        for k, w in one[part].items():
            assert np.array_equal(rec[part][k], w), (part, k)


@pytest.mark.parametrize("arch", ODD_ARCHS)
def test_modules_that_do_not_split_run_replicated(run22, arch):
    """Widths that do not split over tp = 2 (3 heads, d_ff 129, vocab 257):
    wq, bq and w_in stay sharded as the reference's ``_divisible`` leaves
    them, the vocab replicated, and those modules compute replicated (the
    whole weight gathered, each rank's gradient its own block of the
    whole): the step within the f32 bounds of one device's."""
    rec, one = run22[0]["odd"][arch], odd_step(arch, None)
    assert rec["specs"]["layers.0.attn.wq"] == ("data", "model")
    assert rec["specs"]["layers.0.mlp.w_in"] == ("data", "model")
    assert rec["specs"]["embed"] == (None, "data")
    for k in ("loss", "ce", "grad_norm"):
        assert _rel(rec["metrics"][k], one["metrics"][k]) <= LOSS_RTOL, k
    for part in ("grads", "m", "v"):
        err, leaf = _worst(rec[part], one[part])
        assert err <= GRAD_RTOL, (part, leaf, err)
    _params_close(rec["params"], one["params"], rec["m"], one["m"])


def test_pure_fsdp_profile_is_refused():
    from repro_torch.distributed.collectives import Parallel
    from repro_torch.launch.mesh import Mesh
    with pytest.raises(NotImplementedError, match="pure-FSDP"):
        Parallel(Mesh.one_rank(("data", "model")), ("data", "model"), "model")


def test_every_rank_holds_the_same_loss(run22, run24, run12):
    for run in (run22, run24):
        losses = {r["f32"]["internlm2-1.8b"] is None for r in run[1:]}
        assert losses == {True}                         # rank 0 carries the trees
    assert len({r["next_loss"] for r in run22}) == 1
    assert len({r["next_loss"] for r in run12}) == 1


def test_accum_on_mesh_matches_one_device(io, run22):
    rec, one = run22[0]["accum"], port_one_device(io, "internlm2-1.8b", accum=2)
    assert _rel(rec["metrics"]["loss"], one["metrics"]["loss"]) <= LOSS_RTOL
    assert rec["metrics"]["ce"] == rec["metrics"]["loss"] and rec["metrics"]["aux"] == 0
    for part in ("grads", "m", "v"):
        err, leaf = _worst(rec[part], one[part])
        assert err <= GRAD_RTOL, (part, leaf, err)
    _params_close(rec["params"], one["params"], rec["m"], one["m"])


def test_int8_on_mesh_matches_one_device(io, run22):
    """One scale a stacked leaf, its largest magnitude a max over the
    blocks: the codes are one device's but where a gradient sits within
    rounding of a code boundary (at most ``MAX_CODE_FLIPS`` elements of m,
    each one code)."""
    rec, one = run22[0]["int8"], port_one_device(io, "internlm2-1.8b",
                                                                compress=True)
    assert _rel(rec["metrics"]["loss"], one["metrics"]["loss"]) <= LOSS_RTOL
    flips = sum(int((np.abs(rec["m"][k] - w) > GRAD_RTOL * np.abs(w).max()).sum())
                for k, w in one["m"].items())
    assert flips <= MAX_CODE_FLIPS
    err, leaf = _worst(rec["m"], one["m"])
    assert err <= 1.01 / 127, (leaf, err)
    err, leaf = _worst(rec["ef"], one["ef"])
    assert err <= 1.01 / 127 or flips, (leaf, err)


def test_moe_drops_match_one_device(io, run22):
    """qwen3-moe's layer 0 on (2, 2) (dp-global capacity and rank offsets)
    against one device: the dispatch path, the same capacity, the same
    dropped assignments index for index (some drop), the output and every
    expert block's gradient close."""
    d, _ = io
    rec = run22[0]["moe"]
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                              capacity_factor=DROP_CAPACITY)
    model = convert.params_from_reference(cfg, _tree(d, "qwen3-moe-235b-a22b"))
    with np.load(d / "moe.batch.npz") as f:
        x = torch.from_numpy(f["x"]).requires_grad_()
        cot = torch.from_numpy(f["cot"])
    stats: dict = {}
    layer = model.layers[0].moe
    out, aux = moe.moe_forward(layer, cfg, x, stats=stats)
    torch.autograd.backward([out, aux], [cot, torch.ones_like(aux)])
    assert rec["path"] == stats["path"] == "dispatch"
    assert rec["capacity"] == stats["capacity"]
    want = stats["dropped"].view(x.shape[0], -1)
    assert want.any() and torch.equal(rec["dropped"], want)
    assert abs(rec["aux"] - float(aux.detach())) <= LOSS_RTOL * float(aux.detach())
    assert float((rec["out"] - out.detach()).abs().max()) <= MOE_OUT_TOL * float(
        out.abs().max())
    assert float((rec["x_grad"] - x.grad).abs().max()) <= GRAD_RTOL * float(x.grad.abs().max())
    for k, p in layer.named_parameters():
        err = float((rec["grads"][k] - p.grad).abs().max() / p.grad.abs().max())
        assert err <= GRAD_RTOL, (k, err)


def test_reshard_state_round_trips(run22):
    """A global state placed and gathered back is bitwise the input; an MHA
    model placed as the reference's ``reshard_state`` places it (no
    ``cfg``: K/V replicated over model) moves to its config's placement."""
    for r in run22:
        rec = r["reshard"]
        assert rec["ok"] and rec["gqa_wk"] == ("data", None) and rec["mha_wk"] == ("data",
                                                                                   "model")


def test_block_draw_is_the_placed_draw(run22):
    """A model drawn on the mesh (each layer, and an MoE layer's experts,
    cut to its blocks as it is drawn) holds bitwise the blocks, with the
    specs, that ``reshard_state`` cuts from the one-device draw: the seven
    configs, an MHA variant, and llama4's MoE layer with its shared
    expert, on every rank."""
    for r in run22:
        for name, rec in r["block_draw"].items():
            assert rec == dict(names=True, ctx=True, equal=True), name


def test_checkpoint_across_meshes(io, run22, run12):
    """Written on (2, 2) (global arrays, rank 0), restored on (1, 2) and on
    one device bitwise; the next step's loss on each within 1e-6 of the
    (2, 2) run's."""
    d, _ = io
    cfg = get_config("internlm2-1.8b").reduced()
    saved = run22[0]["saved"]
    r12 = run12[0]
    one, loss_one, step_one = restore_step(cfg, None, str(d / "ckpt"))
    assert r12["step"] == step_one == 1
    for part in ("params", "m", "v"):
        for k, w in saved[part].items():
            assert np.array_equal(r12["restored"][part][k], w), (part, k)
            assert np.array_equal(one[part][k], w), (part, k)
    straight = run22[0]["next_loss"]
    assert _rel(r12["next_loss"], straight) <= TRAINER_RTOL
    assert _rel(loss_one, straight) <= TRAINER_RTOL


def test_trainer_on_two_ranks(run12):
    """``launch.train.main`` on 2 gloo ranks (the (1, 2) mesh) against one
    process: the losses within 1e-6 relative, straight and with
    ``--compress --accum 2``; a run failing at step 2 and resumed from its
    checkpoint ends on the straight run's last loss."""
    r = run12[0]
    assert r["mesh"] == {"data": 1, "model": 2}
    straight = port_train.main(TRAINER + ["--steps", "4"])["losses"]
    options = port_train.main(TRAINER + ["--steps", "2", "--compress", "--accum", "2"])["losses"]
    for got, want in ((r["straight"], straight), (r["options"], options)):
        assert len(got) == len(want)
        assert all(_rel(a, b) <= TRAINER_RTOL for a, b in zip(got, want)), (got, want)
    assert r["failed_at"] == 2 and len(r["resumed"]) == 2     # steps 2 and 3 again
    assert all(_rel(a, b) <= TRAINER_RTOL for a, b in zip(r["resumed"], r["straight"][2:]))
