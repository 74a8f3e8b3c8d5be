"""Hymba-1.5B [arXiv:2411.13676; hf]: 32L, d_model 1600, 25H/5KV, d_ff 5504,
vocab 32001, parallel attention + Mamba heads per layer, ssm_state 16,
SWA everywhere except 3 global full-attention layers (first/middle/last)."""
from . import ArchConfig

CONFIG = ArchConfig(
    name='hymba-1.5b', family='hybrid',
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab_size=32001, ssm_state=16, sliding_window=1024,
    global_layer_ids=(0, 15, 31), conv_kernel=4,
    param_dtype='float32', optimizer='adamw', remat='full',
)

SMOKE = CONFIG.replace(
    name='hymba-smoke', n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, ssm_state=8, sliding_window=16,
    global_layer_ids=(0, 3), remat='none')
