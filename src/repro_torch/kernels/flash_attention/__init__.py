"""K8, blockwise online-softmax attention (``csrc/flash_attention.cu``),
its plain PyTorch version (``ref``) and its public op (``mha``)."""
from .kernel import flash_attention
from .ops import mha
from .ref import attention_ref

__all__ = ['flash_attention', 'mha', 'attention_ref']
