from stylex_tpu_torch.eval.fid import (
    FeatureStats,
    alexnet_features_fn,
    compute_feature_stats,
    fid_from_image_batches,
    frechet_distance,
    resize_bilinear,
    resolve_feature_fn,
)

__all__ = [
    "FeatureStats",
    "alexnet_features_fn",
    "compute_feature_stats",
    "fid_from_image_batches",
    "frechet_distance",
    "resize_bilinear",
    "resolve_feature_fn",
]
