"""Post-training int8 quantization for the deconv inference stack.

Activation observers calibrate per-layer ranges (`calibrate`), weights
quantize per output channel (`quantize_params`), and the int8 kernel
(`kernels.deconv2d.deconv2d_int8`, on weights packed once by
`pack_quantized_params`) runs the whole generator with int32 accumulation
and a fused requant + bias + activation epilogue
(`quantized_generator_apply`).
"""
from .calibrate import (OBSERVERS, LayerQuant, QuantConfig, calibrate,
                        observe_amax, quantize_params)
from .evaluate import mmd_degradation
from .infer import (pack_quantized_params, quantized_generator_apply,
                    quantized_generator_ref)
from .qmath import (QMAX, dequantize_symmetric, fake_quant,
                    quantize_absmax, quantize_symmetric, symmetric_scale)

__all__ = [
    "OBSERVERS", "LayerQuant", "QuantConfig", "calibrate", "observe_amax",
    "quantize_params", "mmd_degradation", "pack_quantized_params",
    "quantized_generator_apply",
    "quantized_generator_ref", "QMAX", "dequantize_symmetric", "fake_quant",
    "quantize_absmax", "quantize_symmetric", "symmetric_scale",
]
