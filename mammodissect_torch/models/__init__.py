"""Model zoo: EfficientNet, BERT and the BreastClip dual encoder."""

from mammodissect_torch.models.efficientnet import EfficientNet, EfficientNetMammo
from mammodissect_torch.models.layers import (
    GeM,
    LinearClassifier,
    LinearProjectionHead,
    MLPProjectionHead,
    SqueezeExcite,
)

__all__ = [
    "GeM",
    "LinearClassifier",
    "LinearProjectionHead",
    "MLPProjectionHead",
    "SqueezeExcite",
    "EfficientNet",
    "EfficientNetMammo",
]
