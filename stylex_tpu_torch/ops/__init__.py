from stylex_tpu_torch.ops.blur import (
    LAUNCHES,
    blur3,
    blur3_downsample2x,
    blur3_downsample2x_plain,
    blur3_plain,
    reset_launches,
    upsample2x_bilinear,
    upsample2x_bilinear_plain,
)
from stylex_tpu_torch.ops.latents import (
    expand_styles,
    image_noise,
    latent_noise,
    lpips_normalize,
    mixed_w_styles,
    mixing_cutoff,
    slerp,
    truncate_w,
)
from stylex_tpu_torch.ops.modconv import demod_scale, modulated_conv2d

__all__ = [
    "LAUNCHES",
    "blur3",
    "blur3_plain",
    "blur3_downsample2x",
    "blur3_downsample2x_plain",
    "reset_launches",
    "upsample2x_bilinear",
    "upsample2x_bilinear_plain",
    "expand_styles",
    "image_noise",
    "latent_noise",
    "lpips_normalize",
    "mixed_w_styles",
    "mixing_cutoff",
    "slerp",
    "truncate_w",
    "demod_scale",
    "modulated_conv2d",
]
