from repro_torch.models.cnn import ResNet, VGG, resnet18, resnet50_basic, vgg16
from repro_torch.models.model import build_model
from repro_torch.models.transformer import LM

__all__ = ["LM", "ResNet", "VGG", "build_model", "resnet18", "resnet50_basic",
           "vgg16"]
