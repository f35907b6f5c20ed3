"""mamba2-780m [ssm] — SSD (state-space duality). [arXiv:2405.21060]

48L d_model=1536, attention-free, vocab=50280, ssm_state=128.  Sub-quadratic:
runs the long_500k shape (constant-size SSM state at decode).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                     # attn-free, no MLP: interleaved mamba blocks only
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,            # d_inner=3072 -> 48 SSD heads
    ssm_chunk=128,
    tie_embeddings=True,        # GPT-NeoX tokenizer family convention
    subquadratic=True,
    notes="paper-technique inapplicable (no linear solve); SSD chunked scan "
          "reuses the solver's plane-carry blocking pattern (DESIGN.md §4)",
))
