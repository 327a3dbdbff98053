"""Layers of the port (counterpart of paddle_tpu/nn)."""

from .layer import Layer, LayerList, Parameter, Sequential
from .layers import (GELU, RNN, BatchNorm, BilinearTensorProduct, Conv2D,
                     Conv2DTranspose, Dropout, Embedding, Flatten, GroupNorm,
                     GRUCell, LayerNorm, Linear, LSTMCell,
                     MultiHeadAttention, Pool2D, PRelu, ReLU, RMSNorm,
                     Sigmoid, Softmax, SpectralNorm, Tanh)
from .lora import LoRALinear, apply_lora, lora_parameters, merge_lora
from .moe import SwitchFFN
from .rnn_layers import GRU, LSTM
from .sampling_layers import NCE, HSigmoid
from .transformer import (FeedForward, LearnedPositionalEmbedding,
                          PositionalEncoding, TransformerDecoder,
                          TransformerDecoderLayer, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["Layer", "LayerList", "Parameter", "Sequential", "BatchNorm",
           "Conv2D", "Conv2DTranspose", "Dropout", "Embedding", "Flatten",
           "GELU", "GroupNorm", "LayerNorm", "Linear", "MultiHeadAttention",
           "Pool2D", "PRelu", "ReLU", "RMSNorm", "Sigmoid", "Softmax",
           "Tanh", "GRUCell", "LSTMCell", "RNN", "GRU", "LSTM",
           "SwitchFFN", "BilinearTensorProduct", "LoRALinear",
           "apply_lora", "lora_parameters", "merge_lora", "NCE", "HSigmoid",
           "FeedForward", "LearnedPositionalEmbedding",
           "PositionalEncoding", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer", "SpectralNorm"]
