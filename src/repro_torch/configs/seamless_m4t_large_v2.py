"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal.
[arXiv:2308.11596]

24L (enc) + 24L (dec) d_model=1024 16H (MHA kv=16) d_ff=8192 vocab=256206.
The audio frontend (w2v-BERT conformer) is a STUB: input_specs() provides
precomputed frame embeddings to the text-decoder-facing encoder.  Decode
shapes run the autoregressive decoder with self+cross KV caches.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    enc_dec=True,
    n_enc_layers=24,
    act="gelu",
    frontend="audio",
))
