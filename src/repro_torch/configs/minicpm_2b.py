"""minicpm-2b [dense] — WSD schedule, llama-like arch. [arXiv:2404.06395]

40L d_model=2304 36H (MHA kv=36) d_ff=5760 vocab=122753.  µP-style scaling:
embeddings ×12, residual branches ×(1.4/sqrt(40)), logits ×(256/2304).
The WSD (warmup-stable-decay) schedule lives in repro/optim/schedules.py and
is this arch's default training schedule.
"""
import math
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
    embed_scale=12.0,
    residual_scale=1.4 / math.sqrt(40),
    logit_scale=256.0 / 2304.0,
))
