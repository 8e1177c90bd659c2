"""Layout, quantization, rank-key and selection primitives of the port."""
from repro_torch.core.quantization import (
    QuantizedTensor,
    dequantize,
    fake_quantize,
    quantize,
)

__all__ = ["QuantizedTensor", "dequantize", "fake_quantize", "quantize"]
