"""K8, blockwise online-softmax attention (``csrc/flash_attention.cu``),
its plain PyTorch versions (``ref``: the attention itself and a mirror of
the kernel's split schedule), its schedule rule (``attention_geometry``),
its public op (``mha``), and its training side (``backward``: the
hand-written backward ``csrc/flash_attention_bwd.cu``, its launch rule
``attention_bwd_geometry``, its plain version ``attention_bwd_ref`` and
the mirror of its tensor-core arithmetic ``attention_bwd_mixed_ref``, and
the autograd op ``attention_train``)."""
from .backward import (attention_train, flash_attention_bwd,
                       flash_attention_bwd_kv, flash_attention_bwd_q)
from .kernel import (AttentionBwdGeometry, AttentionGeometry,
                     attention_bwd_geometry, attention_geometry,
                     flash_attention)
from .ops import mha
from .ref import (attention_bwd_mixed_ref, attention_bwd_ref,
                  attention_delta, attention_ref, attention_split_ref,
                  live_key_range, tf32_round)

__all__ = ['AttentionGeometry', 'attention_geometry', 'flash_attention',
           'mha', 'attention_ref', 'attention_split_ref', 'live_key_range',
           'attention_bwd_ref', 'attention_bwd_mixed_ref', 'tf32_round',
           'attention_delta', 'attention_train', 'AttentionBwdGeometry',
           'attention_bwd_geometry', 'flash_attention_bwd',
           'flash_attention_bwd_kv', 'flash_attention_bwd_q']
