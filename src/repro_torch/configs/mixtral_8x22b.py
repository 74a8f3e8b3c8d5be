"""Mixtral 8x22B [arXiv:2401.04088; hf]: 56L, d_model 6144, 48H/8KV GQA,
8 experts top-2 (d_ff 16384), sliding-window attention, vocab 32768.
SWA bounds the KV cache, so long_500k is runnable."""
from . import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name='mixtral-8x22b', family='moe',
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=32768, sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=16384),
    param_dtype='bfloat16', optimizer='adafactor', remat='full',
)

SMOKE = CONFIG.replace(
    name='mixtral-smoke', n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, sliding_window=16,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff=128),
    param_dtype='float32', remat='none')
