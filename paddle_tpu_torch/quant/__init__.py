"""Quantization of the port (counterpart of paddle_tpu/quant): fake
quantization at abs-max, moving-average and sliding-window scales and
the shared abs-max int8 encode/decode (``ops``), QAT/PTQ by layer
rewrite (``qat``), int8 execution of frozen Linear and Conv2D layers on
the int8 matrix-product kernel (``int8``), and weight-only int8
Linears, W8A16 (``weight_only``), and the int8 gradient all-reduce
(``collectives``)."""

from .collectives import (compress_grads, quantized_pmean,
                          quantized_pmean_tree, quantized_psum,
                          quantized_psum_partitioned)
from .int8 import (Int8Conv2D, Int8Linear, int8_conv2d, int8_linear,
                   int8_swap)
from .ops import (MovingAverageState, RangeState, abs_max_scale,
                  absmax_decode, absmax_encode, dequantize,
                  fake_channel_wise_quantize_abs_max,
                  fake_quantize_abs_max,
                  fake_quantize_moving_average_abs_max,
                  fake_quantize_range_abs_max,
                  moving_average_abs_max_scale, moving_average_state_init,
                  quantize_dequantize, quantize_to_int, range_state_init)
from .qat import QuantConfig, QuantedLayer, calibrate, freeze, quantize_model
from .weight_only import WeightOnlyLinear, apply_weight_only_int8

__all__ = [
    "Int8Conv2D", "Int8Linear", "int8_conv2d", "int8_linear", "int8_swap",
    "MovingAverageState", "abs_max_scale", "absmax_decode", "absmax_encode",
    "dequantize", "fake_channel_wise_quantize_abs_max",
    "fake_quantize_abs_max", "fake_quantize_moving_average_abs_max",
    "moving_average_abs_max_scale", "moving_average_state_init",
    "quantize_dequantize", "quantize_to_int", "RangeState",
    "fake_quantize_range_abs_max", "range_state_init",
    "QuantConfig", "QuantedLayer", "calibrate", "freeze", "quantize_model",
    "WeightOnlyLinear", "apply_weight_only_int8",
    "compress_grads", "quantized_pmean", "quantized_pmean_tree",
    "quantized_psum", "quantized_psum_partitioned",
]
