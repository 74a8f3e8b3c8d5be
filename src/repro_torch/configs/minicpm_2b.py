"""MiniCPM-2B [arXiv:2404.06395; hf]: 40L, d_model 2304, 36H MHA (kv=36),
d_ff 5760, vocab 122753, llama-like arch, WSD schedule (see optim/)."""
from . import ArchConfig

CONFIG = ArchConfig(
    name='minicpm-2b', family='dense',
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab_size=122753, tie_embeddings=True,
    param_dtype='float32', optimizer='adamw', remat='full',
)

SMOKE = CONFIG.replace(
    name='minicpm-smoke', n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, remat='none')
