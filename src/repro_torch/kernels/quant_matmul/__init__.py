"""K7, the int8 x int8 -> int32 matmul with its dequant epilogue
(``csrc/quant_matmul.cu``), its plain PyTorch version (``ref``) and its
public ops (``quantized_linear``, ``quantize_weights``), with its launch
rule (``qmm_geometry``)."""
from .kernel import QmmGeometry, qmm_geometry, quant_matmul
from .ops import quantize_weights, quantized_linear
from .ref import quant_matmul_ref

__all__ = ['QmmGeometry', 'qmm_geometry', 'quant_matmul',
           'quantized_linear', 'quantize_weights', 'quant_matmul_ref']
