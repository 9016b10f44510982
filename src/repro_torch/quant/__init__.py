"""repro_torch.quant — serving-side int8 weight quantization (port of
``repro.quant``; the fp8 stub raises NotImplementedError). Matmuls over
quantized weights run the ``q_matmul`` / ``gs_q_matmul`` CUDA kernels on the
card (``kernels/q_matmul.py``) and their plain versions on the CPU."""
from .core import (INT8_MAX, QuantMeta, QuantTensor, dequantize_int8,
                   is_quant_tensor, quantize_int8, quantize_tensor)
from .weights import (DEFAULT_QUANT_TARGETS, QuantConfig, dequantize_params,
                      is_quantized_tree, quantize_params, tree_bytes)

__all__ = [
    "INT8_MAX", "QuantMeta", "QuantTensor", "QuantConfig",
    "DEFAULT_QUANT_TARGETS", "dequantize_int8", "dequantize_params",
    "is_quant_tensor", "is_quantized_tree", "quantize_int8",
    "quantize_params", "quantize_tensor", "tree_bytes",
]
