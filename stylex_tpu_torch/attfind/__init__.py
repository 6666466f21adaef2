from stylex_tpu_torch.attfind.analysis import (
    filter_unstable_images,
    find_significant_styles,
    merge_and_score,
    rank_styles,
    split_by_class,
    style_vector_distances,
    warn_visualize_top,
)
from stylex_tpu_torch.attfind.extraction import (
    AttFindRecords,
    attfind_extraction,
    find_discriminator_threshold,
    load_records_hdf5,
    save_records_hdf5,
)

__all__ = [
    "AttFindRecords",
    "attfind_extraction",
    "find_discriminator_threshold",
    "load_records_hdf5",
    "save_records_hdf5",
    "filter_unstable_images",
    "find_significant_styles",
    "merge_and_score",
    "rank_styles",
    "split_by_class",
    "style_vector_distances",
    "warn_visualize_top",
]
