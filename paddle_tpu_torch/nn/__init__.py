"""Layers of the port (counterpart of paddle_tpu/nn)."""

from .layer import Layer, LayerList, Sequential
from .layers import (GELU, BatchNorm, Conv2D, Conv2DTranspose, Dropout,
                     Embedding, Flatten, GroupNorm, LayerNorm, Linear,
                     MultiHeadAttention, Pool2D, PRelu, ReLU, RMSNorm,
                     Sigmoid, Softmax, Tanh)
from .transformer import (FeedForward, LearnedPositionalEmbedding,
                          PositionalEncoding, TransformerDecoder,
                          TransformerDecoderLayer, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["Layer", "LayerList", "Sequential", "BatchNorm", "Conv2D",
           "Conv2DTranspose", "Dropout", "Embedding", "Flatten", "GELU",
           "GroupNorm", "LayerNorm", "Linear", "MultiHeadAttention",
           "Pool2D", "PRelu", "ReLU", "RMSNorm", "Sigmoid", "Softmax",
           "Tanh", "FeedForward", "LearnedPositionalEmbedding",
           "PositionalEncoding", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer"]
