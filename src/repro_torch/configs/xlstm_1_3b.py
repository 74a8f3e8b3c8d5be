"""xLSTM-1.3B [arXiv:2405.04517]: 48 blocks, d_model 2048, 4 mLSTM heads,
sLSTM interleaved 1-per-8 (paper ratio 7:1).  d_ff=0: projections live inside
the m/sLSTM blocks.  Each mLSTM block holds full (2d x 2d) q/k/v
projections, so the configuration has 3,605,817,680 parameters (14.42 GB in
f32), not 1.3 B."""
from . import ArchConfig

CONFIG = ArchConfig(
    name='xlstm-1.3b', family='ssm',
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50304, xlstm_slstm_every=8, conv_kernel=4,
    param_dtype='float32', optimizer='adamw',
)

SMOKE = CONFIG.replace(
    name='xlstm-smoke', n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
    vocab_size=256, xlstm_slstm_every=2, remat='none')
