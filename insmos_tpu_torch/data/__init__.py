"""Input data (numpy): the HDL-64E raycast fixture, the KITTI file helpers
and sliding-window dataset with its processing and augmentation, the
cached loader and prefetchers, and synthetic KITTI-format sequences."""
