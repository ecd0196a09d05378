# The simulator's testbeds (convex logistic regression, a small MLP, and
# the paper's non-convex ResNet18 / VGG16 conv nets) and the GQA decoder
# LM the serving engine runs (layers, attention, transformer): plain
# functions on dict trees in the JAX package's layout.
from repro_torch.models import cnn, logreg, mlp
from repro_torch.models.cnn import (apply_resnet18, apply_vgg16,
                                    cross_entropy, init_resnet18, init_vgg16)

__all__ = ["apply_resnet18", "apply_vgg16", "cnn", "cross_entropy",
           "init_resnet18", "init_vgg16", "logreg", "mlp"]
