"""gemma2-2b [dense] — local/global alternating attention, logit softcaps.
[arXiv:2408.00118]

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.  Even layers use a
4096-token sliding window, odd layers are global; attention logits capped at
50, final logits at 30; GeGLU MLP; pre+post layer norms; head_dim 256.
long_500k is SKIPPED: the global layers are quadratic (DESIGN.md §4).
"""
import math
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    act="gelu",
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    local_global=True,
    post_norm=True,
    tie_embeddings=True,
    embed_scale=math.sqrt(2304.0),
))
