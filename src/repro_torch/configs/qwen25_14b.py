"""Qwen2.5-14B [hf:Qwen/Qwen2.5 family]: 48L, d_model 5120, 40H/8KV GQA,
d_ff 13824, vocab 152064, QKV bias."""
from . import ArchConfig

CONFIG = ArchConfig(
    name='qwen2.5-14b', family='dense',
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=13824,
    vocab_size=152064, qkv_bias=True, rope_theta=1e6,
    param_dtype='bfloat16', optimizer='adamw', remat='full',
)

SMOKE = CONFIG.replace(
    name='qwen25-smoke', n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, param_dtype='float32', remat='none')
