"""Architecture config schema + registry: the port's own copy of
``repro/configs/base.py``.

Every architecture is a frozen ``ArchConfig`` in its own module under
``repro_torch/configs/`` (shapes only: no weights, no ``config.json``).  The
``reduced()`` view is what the CPU tests instantiate (same family/topology,
tiny widths); ``launch/serve.py --mode lm`` runs a full config on the card.
"""

from __future__ import annotations

import dataclasses

SHAPES = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    moe_every: int = 1             # llama4: MoE every 2nd layer
    dense_ff: int = 0              # FFN dim of the non-MoE layers when moe_every>1
    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    conv_kernel: int = 4
    # --- attention details ---
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    sliding_window: int = 0        # 0 = full attention
    local_global: bool = False     # gemma2: even layers local(window), odd global
    rope_theta: float = 1e4
    mrope: bool = False
    mrope_sections: tuple[int, ...] = ()
    # --- structure ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    act: str = "silu"              # silu (swiglu) | gelu (geglu)
    norm_eps: float = 1e-6
    post_norm: bool = False        # gemma2 post-layer norms
    tie_embeddings: bool = False
    # --- scaling (minicpm µP-style) ---
    embed_scale: float = 1.0
    residual_scale: float = 1.0
    logit_scale: float = 1.0
    # --- modality frontend (stubbed: inputs are precomputed embeddings) ---
    frontend: str = "none"         # none | vision | audio
    # --- applicability flags ---
    subquadratic: bool = False     # may run long_500k
    notes: str = ""

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def has_attn(self) -> bool:
        return self.family != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def shapes(self) -> dict[str, tuple[int, int, str]]:
        out = dict(train_4k=SHAPES["train_4k"], prefill_32k=SHAPES["prefill_32k"],
                   decode_32k=SHAPES["decode_32k"])
        if self.subquadratic:
            out["long_500k"] = SHAPES["long_500k"]
        return out

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16,
            ssm_chunk=16,
            sliding_window=min(self.sliding_window, 8) if self.sliding_window else 0,
            mrope_sections=(2, 3, 3) if self.mrope else (),
        )

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline cross-checks)."""
        d, L = self.d_model, self.n_layers
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        n = self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                 # lm head
        glu = 2 if self.act in ("silu", "gelu") else 1

        def attn_params():
            p = d * H * hd + 2 * d * KV * hd + H * hd * d
            if self.qkv_bias:
                p += (H + 2 * KV) * hd
            return p

        def mlp_params(ff):
            return d * ff * glu + ff * d

        def ssm_params():
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            proj_in = d * (2 * di + 2 * ns + nh)
            conv = (di + 2 * ns) * self.conv_kernel
            return proj_in + conv + 3 * nh + di * d + di

        per_layer = 2 * d  # norms
        if self.family == "ssm":
            per_layer += ssm_params()
        elif self.family == "hybrid":
            per_layer += attn_params() + ssm_params() + mlp_params(self.d_ff)
        elif self.family == "moe":
            n_moe = L // self.moe_every
            n_dense = L - n_moe
            moe_layer = (attn_params() + 2 * d + d * self.n_experts
                         + self.n_experts * mlp_params(self.d_ff)
                         + (mlp_params(self.d_ff) if self.shared_expert else 0))
            dense_layer = (attn_params() + 2 * d
                           + mlp_params(self.dense_ff or self.d_ff))
            return n + n_moe * moe_layer + n_dense * dense_layer
        else:
            per_layer += attn_params() + mlp_params(self.d_ff)
        n += L * per_layer
        if self.enc_dec:
            enc_layer = attn_params() + mlp_params(self.d_ff) + 2 * d
            cross = attn_params() + d
            n += self.n_enc_layers * enc_layer + self.n_layers * cross
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared expert only)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        glu = 2
        expert = d * self.d_ff * glu + self.d_ff * d
        total = self.param_count()
        inactive = (L // self.moe_every) * (self.n_experts - self.top_k) * expert
        return total - inactive


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> dict[str, ArchConfig]:
    if not _REGISTRY:
        _load_all()
    return dict(_REGISTRY)


def _load_all() -> None:
    from repro_torch.configs import (  # noqa: F401
        gemma2_2b,
        hymba_1_5b,
        internlm2_1_8b,
        llama4_maverick_400b_a17b,
        mamba2_780m,
        minicpm_2b,
        qwen2_5_32b,
        qwen2_vl_7b,
        qwen3_moe_235b_a22b,
        seamless_m4t_large_v2,
    )
