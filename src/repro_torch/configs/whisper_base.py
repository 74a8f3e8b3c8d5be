"""Whisper-base [arXiv:2212.04356]: enc-dec, 6+6L, d_model 512, 8H, d_ff 2048,
vocab 51865.  Conv frontend is a STUB: the source is precomputed frame
embeddings (B, 1500, 512)."""
from . import ArchConfig

CONFIG = ArchConfig(
    name='whisper-base', family='audio',
    n_layers=6, n_encoder_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=51865, n_source_tokens=1500,
    norm='layernorm', act='gelu',
    param_dtype='float32', optimizer='adamw', remat='none',
)

SMOKE = CONFIG.replace(
    name='whisper-smoke', n_layers=2, n_encoder_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256, n_source_tokens=32)
