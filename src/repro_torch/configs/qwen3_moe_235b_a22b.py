"""qwen3-moe-235b-a22b [moe] — 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B family]

94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,                  # per-expert FFN dim
    vocab_size=151936,
    n_experts=128,
    top_k=8,
    qk_norm=True,               # qwen3 applies RMSNorm to q/k heads
    rope_theta=1e6,
    notes="expert-parallel MoE over the model axis; router+dispatch follow "
          "the paper's overlap principle (DESIGN.md §4)",
))
