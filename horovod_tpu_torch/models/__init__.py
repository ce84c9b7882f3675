"""Models of the port."""

from .resnet import ResNet, ResNet50, ResNet101, ResNet152
from .transformer import Transformer, TransformerConfig

__all__ = ["ResNet", "ResNet50", "ResNet101", "ResNet152", "Transformer",
           "TransformerConfig"]
