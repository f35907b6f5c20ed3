"""hymba-1.5b [hybrid] — parallel attention + mamba heads. [arXiv:2411.13676]

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Attention and SSD heads read the same input in parallel; their normalised
outputs are mean-fused before the output projection.  Sliding-window
attention (2048) keeps decode state bounded -> runs long_500k.  (Hymba's
handful of global-attention layers and meta tokens are simplified to
all-SW + no meta tokens; noted in DESIGN.md §4.)
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    sliding_window=2048,
    subquadratic=True,
))
