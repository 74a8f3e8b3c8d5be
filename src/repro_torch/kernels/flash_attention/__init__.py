"""K8, blockwise online-softmax attention (``csrc/flash_attention.cu``),
its plain PyTorch versions (``ref``: the attention itself and a mirror of
the kernel's split schedule), its schedule rule (``attention_geometry``)
and its public op (``mha``)."""
from .kernel import AttentionGeometry, attention_geometry, flash_attention
from .ops import mha
from .ref import attention_ref, attention_split_ref, live_key_range

__all__ = ['AttentionGeometry', 'attention_geometry', 'flash_attention',
           'mha', 'attention_ref', 'attention_split_ref', 'live_key_range']
