"""Models of the port (counterpart of paddle_tpu/models)."""

from . import (alexnet, bert, deepfm, googlenet, gpt, mnist, recommender,
               resnet, se_resnext, speculative, stacked_lstm, transformer,
               vgg, vit)

__all__ = ["alexnet", "bert", "deepfm", "googlenet", "gpt", "mnist",
           "recommender", "resnet", "se_resnext", "speculative",
           "stacked_lstm", "transformer", "vgg", "vit"]
