"""Models of the port: the conv zoo of the JAX package
(``horovod_tpu/models``: ResNet, VGG, Inception V3, the MNIST net), the
flagship transformer, and word2vec (``models.word2vec``)."""

from .inception import InceptionV3
from .mnist import MnistConvNet
from .resnet import ResNet, ResNet50, ResNet101, ResNet152
from .transformer import Transformer, TransformerConfig
from .vgg import VGG, VGG16, VGG19

__all__ = ["ResNet", "ResNet50", "ResNet101", "ResNet152",
           "VGG", "VGG16", "VGG19", "InceptionV3", "MnistConvNet",
           "Transformer", "TransformerConfig"]
