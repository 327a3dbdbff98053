"""Layers of the port (counterpart of paddle_tpu/nn)."""

from .layer import Layer, LayerList, Sequential
from .layers import (Dropout, Embedding, LayerNorm, Linear,
                     MultiHeadAttention, RMSNorm)

__all__ = ["Layer", "LayerList", "Sequential", "Dropout", "Embedding",
           "LayerNorm", "Linear", "MultiHeadAttention", "RMSNorm"]
