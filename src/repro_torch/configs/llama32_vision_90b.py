"""Llama-3.2-Vision-90B [hf:meta-llama/Llama-3.2-*-Vision]: 100L total,
d_model 8192, 64H/8KV GQA, d_ff 28672, vocab 128256; cross-attention image
layers interleaved 1-per-5.  Vision frontend is a STUB: the source is
pre-projected patch embeddings (B, 1024, 8192)."""
from . import ArchConfig

CONFIG = ArchConfig(
    name='llama-3.2-vision-90b', family='vlm',
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab_size=128256, cross_attn_every=5, n_source_tokens=1024,
    rope_theta=5e5,
    param_dtype='bfloat16', optimizer='adafactor', remat='full',
)

SMOKE = CONFIG.replace(
    name='llama-vision-smoke', n_layers=5, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, n_source_tokens=16,
    param_dtype='float32', remat='none')
