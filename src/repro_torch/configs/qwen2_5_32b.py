"""qwen2.5-32b [dense] — GQA, QKV bias. [hf:Qwen/Qwen2.5 family]

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
))
