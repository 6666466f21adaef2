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
    load_records,
    load_records_hdf5,
    records_file_name,
    save_records,
    save_records_hdf5,
)
from stylex_tpu_torch.attfind.visualize import (
    generate_change_image_given_dlatent,
    generate_images_given_dlatent,
    visualize_style,
    visualize_style_by_distance_in_s,
)

__all__ = [
    "AttFindRecords",
    "attfind_extraction",
    "find_discriminator_threshold",
    "load_records_hdf5",
    "save_records_hdf5",
    "load_records",
    "save_records",
    "records_file_name",
    "filter_unstable_images",
    "find_significant_styles",
    "merge_and_score",
    "rank_styles",
    "split_by_class",
    "style_vector_distances",
    "warn_visualize_top",
    "generate_change_image_given_dlatent",
    "generate_images_given_dlatent",
    "visualize_style",
    "visualize_style_by_distance_in_s",
]
