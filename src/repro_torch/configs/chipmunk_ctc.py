"""The paper's own workload: CTC-3L-421H-UNI (Graves et al.) — 3-layer
421-hidden-unit unidirectional peephole LSTM over 123 MFCC features, 62 CTC
outputs (61 phonemes + blank).  The same values as
``repro.configs.chipmunk_ctc``."""
from . import ArchConfig

CONFIG = ArchConfig(
    name='chipmunk-ctc', family='lstm',
    n_layers=3, d_model=421, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab_size=62, lstm_hidden=421, lstm_inputs=123, n_outputs=62,
    param_dtype='float32', activation_dtype='float32',
    optimizer='adamw', remat='none',
)

SMOKE = CONFIG.replace(
    name='chipmunk-smoke', n_layers=2, d_model=32, lstm_hidden=32,
    lstm_inputs=13, vocab_size=16, n_outputs=16)
