"""llama4-maverick-400b-a17b [moe] — MoE top-1 + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E family]

48L d_model=5120 40H (GQA kv=8) expert d_ff=8192 vocab=202048, 128e top-1.
Early-fusion multimodality is a frontend concern and is stubbed (text backbone
exercised; the assignment specifies the transformer backbone only).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    n_experts=128,
    top_k=1,
    shared_expert=True,         # llama4 routes top-1 + always-on shared expert
    moe_every=2,                # MoE every 2nd layer (interleave_moe_layer_step)
    dense_ff=16384,             # the non-MoE layers' FFN dim
    rope_theta=5e5,
    notes="40 heads over 16-way tensor axis is non-divisible; GSPMD pads "
          "(wasted-compute ratio recorded in EXPERIMENTS.md)",
))
