"""Kimi K2 (trillion-param MoE, paper-table config) [arXiv:2501.kimi2]:
61L, d_model 7168, 64 q-heads / 8 kv (GQA), 384 experts top-8, expert d_ff 2048,
vocab 163840.  Active ~32B/token."""
from . import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name='kimi-k2-1t-a32b', family='moe',
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab_size=163840,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff=2048),
    param_dtype='bfloat16', optimizer='adafactor', remat='full',
)

SMOKE = CONFIG.replace(
    name='kimi-smoke', n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, moe=MoEConfig(n_experts=8, top_k=2, d_ff=128),
    param_dtype='float32', remat='none')
