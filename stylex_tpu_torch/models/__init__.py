from stylex_tpu_torch.models.classifiers import (
    ClassifierBundle,
    MobileNetV2,
    ResNet18,
    build_classifier,
    imagenet_normalize,
)
from stylex_tpu_torch.models.discriminator import DiscriminatorE, discriminator_filters
from stylex_tpu_torch.models.generator import (
    Generator,
    generator_filters,
    num_style_coords,
    sindex_to_block_and_offset,
    style_coord_dims,
)
from stylex_tpu_torch.models.mapping import StyleVectorizer
from stylex_tpu_torch.models.stylex import StylEx, build_stylex, ema_update, make_w, prior_w

__all__ = [
    "ClassifierBundle",
    "MobileNetV2",
    "ResNet18",
    "build_classifier",
    "imagenet_normalize",
    "DiscriminatorE",
    "discriminator_filters",
    "Generator",
    "generator_filters",
    "num_style_coords",
    "sindex_to_block_and_offset",
    "style_coord_dims",
    "StyleVectorizer",
    "StylEx",
    "build_stylex",
    "ema_update",
    "make_w",
    "prior_w",
]
