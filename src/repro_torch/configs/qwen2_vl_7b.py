"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution. [arXiv:2409.12191]

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.  Vision frontend is a
STUB: input_specs() provides precomputed patch embeddings + (3, B, S) M-RoPE
position ids (temporal/height/width).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),   # halves of head_dim 128
    rope_theta=1e6,
    frontend="vision",
))
