"""Layers of the port (counterpart of paddle_tpu/nn)."""

from .layer import Layer, LayerList
from .layers import (Dropout, Embedding, Linear, MultiHeadAttention,
                     RMSNorm)

__all__ = ["Layer", "LayerList", "Dropout", "Embedding", "Linear",
           "MultiHeadAttention", "RMSNorm"]
