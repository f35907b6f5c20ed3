"""bf16 models against the reference's bf16 run on the CPU: the reduced
internlm2 (dense), qwen3-moe (MoE, at the no-drop capacity ``E / k``),
mamba2 (SSD) and seamless-m4t (enc-dec), the same converted weights.

How the harness carries bf16 arrays: the reference's tree in bf16 turns into
numpy arrays of ``ml_dtypes``' bfloat16, which ``torch.from_numpy`` does not
take, so ``models.convert.to_tensor`` views each such array as ``uint16``
(its 16-bit patterns) and the tensor as ``torch.bfloat16``: the same bits,
never a cast.  The reference's bf16 logits are read the same way after an
exact cast to f32.

The bounds, in bf16 ulps of the largest logit (``ulp(m) = 2^(⌊log2 m⌋ −
7)``).  Both packages run the same bf16 operations but round their
intermediates at different places (XLA fuses elementwise chains, PyTorch
rounds after every op), so each lands a few ulps from the exact result of
the same bf16 weights, here an f32 run of the port on them exactly widened
(the port's f32 model is held to the reference's within 1e-5 in
``tests/test_torch_models.py``).  The reference's own distance from that
run reaches 4.58 ulps (qwen3-moe's first decode step), so two runs that each
round correctly differ by up to about twice that: the port is held within
``PAIR_ULPS`` (8) of the reference, and its own distance from the f32 run
within ``SLACK_ULPS`` (4) of the reference's (no less accurate than the
reference beyond one side's rounding).  Checked: the prefill's
last-position logits and three greedy decode steps (fed the reference's
argmax); mamba2, whose prefill carries no SSM state, replays its 12 prompt
tokens through decode steps, each step's logits checked.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_harness import ref_module
from test_torch_models import ENC_DEC, Pair, jx, tt
from test_torch_models import one_thread  # noqa: F401  (fixture)

from repro_torch.configs.base import get_config
from repro_torch.models import convert
from repro_torch.models import decode as port_decode
from repro_torch.models import steps as port_steps

ref_decode = ref_module("models.decode")

#: the port's logits from the reference's, in ulps
PAIR_ULPS = 8
#: the port's distance from the f32 run over the reference's, in ulps
SLACK_ULPS = 4
ARCHS = ["internlm2-1.8b", "qwen3-moe-235b-a22b", "mamba2-780m", ENC_DEC]
B, S, STEPS = 2, 12, 3


def ulp(m: float) -> float:
    """The bf16 unit in the last place at magnitude ``m``."""
    return 2.0 ** (math.floor(math.log2(m)) - 7)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _f32_twin(p: Pair):
    """The port's f32 model holding the bf16 weights, exactly widened (the
    f32 arrays, an MoE router's and an SSD block's, as they are)."""
    def widen(x):
        x = np.asarray(x)
        return x.astype(np.float32) if x.dtype.name == "bfloat16" else x
    return convert.params_from_reference(p.cfg, jax.tree.map(widen, p.tree))


class Gaps:
    """Each checked step's logits: port against reference, and each against
    the f32 twin, in ulps of the reference's largest logit."""

    def __init__(self):
        self.rows = []

    def add(self, what: str, got, want, truth):
        g, w, t = f32(got), f32(want), f32(truth)
        u = ulp(float(np.abs(w).max()))
        self.rows.append((what, float(np.abs(g - w).max()) / u, float(np.abs(g - t).max()) / u,
                          float(np.abs(w - t).max()) / u))

    def check(self):
        for row in self.rows:          # shown under ``pytest -s``
            print("%s: port against reference %.2f ulps; from the f32 run: port %.2f, "
                  "reference %.2f" % row)
        for what, pair, port, ref in self.rows:
            assert pair <= PAIR_ULPS, f"{what}: port against reference {pair:.2f} ulps"
            assert port <= ref + SLACK_ULPS, (
                f"{what}: port {port:.2f} ulps from the f32 run, the reference {ref:.2f}")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_and_decode_steps_match_reference(arch):
    red = get_config(arch).reduced()
    no_drop = dict(capacity_factor=red.n_experts / red.top_k) if red.family == "moe" else {}
    p = Pair(arch, jnp.bfloat16, torch.bfloat16, **no_drop)
    assert {t.dtype for n, t in p.model.named_parameters()
            if not n.endswith(("router", "A_log", "D", "dt_bias"))} == {torch.bfloat16}
    twin = _f32_twin(p)
    ctx32 = dataclasses.replace(p.ctx, dtype=torch.float32)
    b = p.batch(B, S, 7)
    bt = {k: tt(v).long() if v.dtype.kind == "i" else tt(v) for k, v in b.items()}
    gaps = Gaps()
    dstep, dstep32 = port_steps.make_decode_step(p.ctx), port_steps.make_decode_step(ctx32)
    with torch.inference_mode():
        if p.cfg.family == "ssm":
            cr = ref_decode.init_caches(p.ctx_r, B, S)
            cg = port_decode.init_caches(p.ctx, B, S)
            ct = port_decode.init_caches(ctx32, B, S)
            for i in range(S):
                tok = b["tokens"][:, i:i + 1]
                lw, cr = p.decode_r(p.tree, jx(tok), jnp.array(i, jnp.int32), cr)
                lg, cg = dstep(p.model, tt(tok).long(), i, cg)
                lt, ct = dstep32(twin, tt(tok).long(), i, ct)
                gaps.add(f"replayed step {i}", lg, lw, lt)
        else:
            lw, kvw = p.prefill_r(p.tree, {k: jx(v) for k, v in b.items()})
            lg, kvg = port_steps.make_prefill(p.ctx)(p.model, bt)
            lt, kvt = port_steps.make_prefill(ctx32)(twin, bt)
            gaps.add("prefill", lg, lw, lt)
            cr = ref_decode.caches_from_prefill(p.ctx_r, kvw, S + STEPS)
            cg = port_decode.caches_from_prefill(p.ctx, kvg, S + STEPS)
            ct = port_decode.caches_from_prefill(ctx32, kvt, S + STEPS)
            xr = xg = xt = ()
            if p.cfg.enc_dec:
                (cr, kr), (cg, kg), (ct, kt) = cr, cg, ct
                xr, xg, xt = (kr,), (kg,), (kt,)
            for s in range(STEPS):
                tok = np.asarray(jnp.argmax(lw[:, -1], axis=-1)).astype(np.int32)[:, None]
                lw, cr = p.decode_r(p.tree, jx(tok), jnp.array(S + s, jnp.int32), cr, *xr)
                lg, cg = dstep(p.model, tt(tok).long(), S + s, cg, *xg)
                lt, ct = dstep32(twin, tt(tok).long(), S + s, ct, *xt)
                gaps.add(f"decode step {s}", lg, lw, lt)
    assert lg.dtype == torch.float32 and bool(torch.isfinite(lg).all())
    gaps.check()
