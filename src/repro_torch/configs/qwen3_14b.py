"""Qwen3-14B [hf:Qwen/Qwen3-8B family]: 40L, d_model 5120, 40H/8KV GQA,
d_ff 17408, vocab 151936, qk-norm (per-head RMSNorm on q,k)."""
from . import ArchConfig

CONFIG = ArchConfig(
    name='qwen3-14b', family='dense',
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=17408,
    vocab_size=151936, qk_norm=True, head_dim=128, rope_theta=1e6,
    param_dtype='bfloat16', optimizer='adamw', remat='full',
)

SMOKE = CONFIG.replace(
    name='qwen3-smoke', n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab_size=256, param_dtype='float32', remat='none')
